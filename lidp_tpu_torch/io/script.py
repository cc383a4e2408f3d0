"""LAMMPS input-script interpreter (lidp_tpu/io/script.py, the commands of
the polarizable main path).

The reference's Input::file/one dispatch (input.cpp:151,286,761) with
$-substitution (input.cpp:330), equal- and atom-style variables through
io/expr.py,
and label/jump/next/if/include control flow.  Command-order semantics are
kept: `units` resets the timestep to the style default (update.cpp
set_units), so an input whose `timestep` precedes `units real` runs dt = 1.

The interpreter gathers the configuration on the host; `run N` assembles
the Simulation (sim.py: the System, the lj/cut, lj/cut/coul/long or
lj/cut/coul/long/polarization tables, ewald, ewald/disp or pppm, the
integrator of the fixes, and the dense route, the cell grid or
FastPolarRunner) on the script's device and advances it.

The commands are those the polarization examples, the polar main path and
the atomic inputs bench/in.lj and examples/melt use (lattice, region
block, create_box, create_atoms, the neighbour schedule and exclusions of
neigh_modify, the mesh k-space and the barostats), and the flexible
molecules of examples/peptide and bench/in.rhodo (the bond, angle,
dihedral and improper styles with their coeff commands and data-file
sections, special_bonds charmm|amber|fene, the lj/charmm pair styles with
the four-argument pair_coeff, fix shake and fix rattle), bench/in.chain
(atom_style bond, fix langevin), the modifier fixes of
styles/fix_modifiers.py, bench/in.eam (pair_style eam, eam/alloy and
eam/fs with their potential files; set type/fraction), examples/min
(dimension 2, fix enforce2d, displace_atoms, and minimize with min_style,
min_modify and fix box/relax: integrate/minimize.py), and examples/crack,
flow and obstacle (boundary f, s and m with the shrink-wrapped box, the
region styles, group region|union|subtract, set ... type, delete_atoms,
velocity ramp and velocity create ... temp, thermo_modify temp, fix_modify
temp, and the walls, indent and move of styles/fix_modifiers.py), and
the computes and output fixes (compute with the styles of computes.py:
chunk/atom, the */chunk computes, the structure computes and heat/flux
among them; uncompute, compute_modify, thermo c_ID[i] and v_NAME columns,
fix print, ave/time, ave/atom, ave/histo, ave/histo/weight,
ave/correlate, vector and ave/chunk of styles/fix_output.py, dump custom
c_ID and f_ID columns), and the
other pair styles (the generic styles of styles/pair_builders.py,
pair_style table with pair_write, hybrid and hybrid/overlay, dpd and
dpd/tstat, pair_modify tail), and the rest of the CHARMM family
(lj/charmmfsw/coul/long|charmmfsh, lj/charmm/coul/charmm/implicit,
dihedral_style charmmfsw), fix cmap (with read_data's `fix ID crossterm
CMAP`, fix_modify ID energy and its f_ID) and the DREIDING hydrogen bonds
(pair_style hbond/dreiding/lj|morse, alone or as a hybrid sub-style),
and bench/in.chute's granular flow (atom_style sphere, pair_style
gran/hooke|hooke/history|hertz/history, neigh_modify exclude group A A,
fix gravity, freeze, nve/sphere, nvt/sphere, wall/gran,
wall/gran/region and pour, and the computes erotate/sphere, temp/sphere,
erotate/sphere/atom and contact/atom: styles/gran_builders.py), and
output and coupling (the local computes pair/local, bond/local,
angle/local, dihedral/local, improper/local, property/local and
rigid/local with dump local; dump xyz, dcd, cfg, image and movie;
read_dump and rerun; fix store/state, variable internal with fix
controller, and fix external with api.py's library calls), and the rest
of the front end (io/commands.py: restart and write_restart /
read_restart with utils/checkpoint.py, timer with utils/timing.py,
clear, quit, shell, info, reset_timestep, partition, dielectric,
run_style verlet, box, comm_style, suffix and package, molecule with
create_atoms mol and random, create_box's topology keywords,
create_bonds, delete_bonds, change_box on an orthogonal box, balance
with parallel/balance.py, bond_write and write_coeff; velocity scale and
zero angular; atom- and world-style variables).  Every other command,
style or keyword raises NotImplementedError naming itself and the
ROADMAP item that ports it, and is never ignored: triclinic boxes and
change_box's tilts (queue 1 item 6.4), run_style respa (6.10), neb,
prd, tad and temper (6.12), processors across devices (7), the breadth
of item 6, and item 4's residue of what the JAX grammar also lacks.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shlex
import time
from typing import Optional

import numpy as np
import torch

from lidp_tpu_torch import computes as computes_mod
from lidp_tpu_torch import resolve_device
from lidp_tpu_torch import units as units_mod
from lidp_tpu_torch import velocity as velocity_mod
from lidp_tpu_torch.io import expr as expr_mod
from lidp_tpu_torch.io.commands import (_BREADTH, _FRONT_END, _TRICLINIC,
                                        FrontEndCommands, _unported)
from lidp_tpu_torch.io.data_reader import read_data
from lidp_tpu_torch.styles import fix_output
from lidp_tpu_torch.styles.fix_output import OUTPUT_STYLES
from lidp_tpu_torch.styles.pair_builders import HBOND_STYLES

# bare-number detector for optional positional args (the pair_style
# polarization grammar's optional cut_coul before keywords)
_NUM_RE = re.compile(r"^[\d eE+\-*/().]+$")
# an equal-style variable that is a ramp of two constants (fix adapt)
_RAMP_RE = re.compile(r"^ramp\(\s*([0-9.eE+-]+)\s*,\s*([0-9.eE+-]+)\s*\)$")

# create_box's topology keywords (create_box.cpp), each with a count
_CREATE_BOX_KEYWORDS = (
    "bond/types", "angle/types", "dihedral/types", "improper/types",
    "extra/bond/per/atom", "extra/angle/per/atom",
    "extra/dihedral/per/atom", "extra/improper/per/atom",
    "extra/special/per/atom")

# thermo keywords the port's thermo row gives (thermo.thermo_row and
# Simulation._thermo_row)
THERMO_KEYWORDS = frozenset((
    "step", "temp", "ke", "pe", "etotal", "evdwl", "ecoul", "elong", "epol",
    "epair", "emol", "ebond", "eangle", "edihed", "eimp", "press", "vol",
    "density", "lx", "ly", "lz", "xlo", "ylo", "zlo", "xhi", "yhi", "zhi",
    "xy", "xz", "yz", "atoms", "bonds", "dt"))

# the generic pair styles: one van der Waals kind x coulomb kind
# (sim.GENERIC_PAIR_KINDS, ops/pair.py generic_vdw)
GENERIC_STYLES = (
    "morse", "buck", "buck/coul/cut", "buck/coul/long", "yukawa", "gauss",
    "soft", "born", "coul/cut", "coul/long", "coul/msm", "coul/debye",
    "lj/expand", "born/coul/long", "mie/cut", "lj/gromacs", "coul/dsf",
    "coul/wolf", "born/coul/dsf", "born/coul/wolf", "born/coul/msm",
    "buck/coul/msm", "lj/gromacs/coul/gromacs", "beck", "zero", "lj96/cut",
    "lj/smooth/linear", "lj/smooth", "ufm", "zbl", "lj/cubic")
# lj/cut with the other coulomb kinds (the lj/cut tables)
LJ_COUL_STYLES = ("lj/cut/coul/cut", "lj/cut/coul/debye", "lj/cut/coul/dsf",
                  "lj/cut/coul/wolf")
# pair styles Simulation.from_script builds
PAIR_STYLES = ("lj/cut", "lj/cut/coul/long", "lj/cut/coul/long/polarization",
               "lj/charmm/coul/long", "lj/charmm/coul/charmm",
               "lj/long/coul/long", "buck/long/coul/long",
               "lj/cut/tip4p/long", "lj/cut/tip4p/cut", "tip4p/long",
               "tip4p/cut", "lj/long/tip4p/long", "lj/cut/coul/msm",
               "lj/charmm/coul/msm") + LJ_COUL_STYLES + GENERIC_STYLES + (
                   "table", "dpd", "dpd/tstat", "hybrid", "hybrid/overlay",
                   "lj/charmm/coul/charmm/implicit", "lj/charmmfsw/coul/long",
                   "lj/charmmfsw/coul/charmmfsh", "hbond/dreiding/lj",
                   "hbond/dreiding/morse")
# the granular styles (ops/granular.py), on atom_style sphere data
GRAN_STYLES = ("gran/hooke", "gran/hooke/history", "gran/hertz/history")
# registration aliases (pair_lj_smooth_linear.h:17 lj/sf)
PAIR_STYLE_ALIASES = {"lj/sf": "lj/smooth/linear"}
# the TIP4P styles: the oxygen's charge on the M site (ops/tip4p.py)
TIP4P_STYLES = ("lj/cut/tip4p/long", "lj/cut/tip4p/cut", "tip4p/long",
                "tip4p/cut", "lj/long/tip4p/long")
# the k-space styles the script reads (pppm/cg and msm/cg run as pppm and
# msm)
KSPACE_STYLES = ("ewald", "ewald/disp", "pppm", "pppm/cg", "pppm/stagger",
                 "pppm/tip4p", "pppm/disp", "pppm/disp/tip4p", "msm",
                 "msm/cg")
# the many-body styles (ops/eam.py): the cutoff comes from the potential
# file that pair_coeff names
EAM_STYLES = ("eam", "eam/alloy", "eam/fs")
# fix cmap's crossterms where the JAX package keeps them off their atoms
_CMAP_ITEM = "ROADMAP queue 3 item 39, fix cmap beyond the dense route"
# every style name the JAX interpreter knows: a hybrid's argument list
# splits at these (PairHybrid::settings, pair_hybrid.cpp)
KNOWN_PAIR_STYLES = frozenset(
    PAIR_STYLES + EAM_STYLES + tuple(PAIR_STYLE_ALIASES)) - {
        "hybrid", "hybrid/overlay"}
# pair_coeff's coefficient count of the generic styles (the JAX package's
# script.py _NCOEFF), the cutoff after them optional
_NCOEFF = {"morse": 3, "buck": 3, "buck/coul/cut": 3, "buck/coul/long": 3,
           "yukawa": 1, "gauss": 2, "soft": 1, "born": 5, "coul/cut": 0,
           "coul/long": 0, "coul/debye": 0, "coul/msm": 0, "lj/expand": 3,
           "born/coul/long": 5, "mie/cut": 4, "born/coul/dsf": 5,
           "born/coul/wolf": 5, "beck": 5, "born/coul/msm": 5,
           "buck/coul/msm": 3, "coul/dsf": 0, "coul/wolf": 0, "zero": 0,
           "zbl": 2, "dpd": 2, "dpd/tstat": 1}


def _read_pair_table(path: str, keyword: str):
    """One section of a LAMMPS pair table file (pair_table.cpp read_table;
    the JAX package's script.py _read_pair_table): the KEYWORD line, its
    `N n ...` line, then n rows `i r E F`.  Returns the r, E, F arrays."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines):
        t = lines[i].split("#")[0].strip()
        if t == keyword or t.split()[:1] == [keyword]:
            break
        i += 1
    else:
        raise ValueError(f"table keyword {keyword!r} not found in {path}")
    i += 1
    n = None
    while i < len(lines):
        t = lines[i].split("#")[0].split()
        i += 1
        if t and t[0] == "N":
            n = int(t[1])
            break
    if n is None:
        raise ValueError(f"no N line after keyword {keyword!r}")
    rows = []
    while i < len(lines) and len(rows) < n:
        t = lines[i].split("#")[0].split()
        if len(t) >= 4:
            rows.append((float(t[1]), float(t[2]), float(t[3])))
        i += 1
    r, e, f = (np.array([row[k] for row in rows]) for k in range(3))
    return r, e, f

# fix styles with a builder (styles/fix_integrators.py, fix_modifiers.py)
FIX_STYLES = ("nve", "nve/limit", "nve/noforce", "nvt", "npt", "nph",
              "nvt/sphere", "npt/sphere", "nph/sphere", "rigid",
              "rigid/nve", "rigid/nvt",
              "rigid/npt", "rigid/nph", "rigid/small", "rigid/nve/small",
              "rigid/nvt/small", "rigid/npt/small", "rigid/nph/small",
              "shake", "rattle", "langevin", "setforce", "addforce",
              "aveforce", "spring", "spring/self", "viscous", "efield",
              "planeforce", "lineforce", "momentum", "recenter",
              "temp/rescale", "temp/berendsen", "temp/csld", "enforce2d",
              "box/relax", "wall/reflect", "wall/lj93", "wall/lj126",
              "wall/lj1043", "wall/harmonic", "wall/region", "indent",
              "move", "cmap", "external", "temp/csvr",
              "press/berendsen", "deform", "tmd", "adapt", "drag",
              "spring/rg", "spring/chunk", "restrain", "store/force",
              "heat", "ehex", "halt", "dt/reset") + (
                  # the granular route's (sim.py _build_granular_sim)
                  "gravity", "freeze", "nve/sphere", "wall/gran",
                  "wall/gran/region", "pour")
# where the fix styles the port lacks are queued: the modifier fixes of
# the JAX package's styles/fix_modifiers.py, and the others by their item
_MODIFIERS = "ROADMAP queue 1 item 6.1, the modifier fixes"
_FIX_ITEMS = {
    "nvt/sllod": _TRICLINIC,
    "neb": "ROADMAP queue 1 item 6.12, replicas (the neb command)",
}

# the compute styles (computes.py and sim.py) and where the others are
# queued
COMPUTE_STYLES = (
    "temp", "temp/partial", "temp/com", "temp/ramp", "temp/region",
    "temp/profile", "temp/deform", "pe", "ke", "com", "gyration", "msd",
    "vacf", "rdf",
    "group/group", "pressure", "reduce", "reduce/region", "slice",
    "ke/rigid", "erotate/rigid", "ke/atom", "pe/atom", "stress/atom",
    "coord/atom", "cluster/atom", "displace/atom", "property/atom",
    "centro/atom", "cna/atom", "orientorder/atom", "hexorder/atom",
    "fragment/atom", "aggregate/atom", "global/atom", "heat/flux",
    "chunk/atom", "com/chunk", "vcm/chunk", "gyration/chunk",
    "angmom/chunk", "torque/chunk", "inertia/chunk", "omega/chunk",
    "dipole/chunk", "msd/chunk", "property/chunk", "temp/chunk",
    "erotate/sphere", "temp/sphere", "erotate/sphere/atom", "contact/atom",
    # the local computes (io/dump.py), read by dump local
    "pair/local", "bond/local", "angle/local", "dihedral/local",
    "improper/local", "property/local", "rigid/local")
# the sphere computes, read on the granular route alone
SPHERE_COMPUTES = ("erotate/sphere", "temp/sphere", "erotate/sphere/atom",
                   "contact/atom")
# the structure computes (computes.py)
_STRUCTURE_STYLES = ("centro/atom", "cna/atom", "orientorder/atom",
                     "hexorder/atom", "fragment/atom", "aggregate/atom",
                     "global/atom")
# JAX's thermo row has no value for these (ROADMAP queue 3 item 26)
_NO_VALUE = "ROADMAP queue 3 item 26, values JAX's thermo row lacks"
_OUTPUT_FIXES = "ROADMAP queue 3 item 25, keywords JAX skips"

# the min styles of integrate/minimize.py
MIN_STYLES = ("fire", "cg", "sd", "quickmin", "hftn")

# the bonded styles (ops/bonded.py, styles/bonded_builders.py)
BOND_STYLES = ("harmonic", "fene", "fene/expand", "morse", "nonlinear",
               "gromos", "quartic", "table", "zero", "hybrid")
ANGLE_STYLES = ("harmonic", "charmm", "cosine", "cosine/squared",
                "cosine/delta", "cosine/periodic", "table", "zero", "hybrid")
DIHEDRAL_STYLES = ("opls", "harmonic", "charmm", "charmmfsw",
                   "multi/harmonic", "helix", "zero", "hybrid")
IMPROPER_STYLES = ("harmonic", "cvff", "umbrella", "zero", "hybrid")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(p):
    """A pair table's tensors on the host (pair_write's rows are formed
    there)."""
    return dataclasses.replace(p, **{
        f.name: getattr(p, f.name).cpu() for f in dataclasses.fields(p)
        if isinstance(getattr(p, f.name), torch.Tensor)})


def _yesno(tok: str) -> bool:
    if tok == "yes":
        return True
    if tok == "no":
        return False
    raise ValueError(f"expected yes/no, got {tok!r}")


@dataclasses.dataclass
class PairStyleSpec:
    name: str = ""
    cut_lj_global: float = 0.0
    cut_coul: float = 0.0
    # the CHARMM switches' inner cutoffs (lj/charmm/*)
    cut_lj_inner: float = 0.0
    cut_coul_inner: float = 0.0
    # polarization keywords, defaults per constructor
    # (...polarization.cpp:63-79)
    iterations_max: int = 50
    damping_type: str = "none"
    polar_damp: float = 2.1304
    zodid: bool = False
    polar_precision: float = 1e-11
    fixed_iteration: bool = False
    polar_gs: bool = False
    polar_gs_ranked: bool = True
    polar_gamma: float = 1.03
    use_previous: bool = False
    debug: bool = False
    # the TIP4P styles: (O type, H type, O-H bond type, H-O-H angle type,
    # qdist), and "long" (erfc + k-space) or "cut" (the bare coulomb)
    tip4p: tuple = None
    tip4p_mode: str = "long"


@dataclasses.dataclass
class FixSpec:
    fid: str
    group: str
    style: str
    args: list


@dataclasses.dataclass
class DumpSpec:
    did: str
    group: str
    style: str
    every: int
    path: str
    columns: list
    float_fmt: str = "%g"   # dump_modify format float


class LammpsScript(FrontEndCommands):
    """Host-side interpreter state + executor.  dtype: the runs' float
    type (float64 by default, as the JAX CLI's); device: where they run
    (the GPU unless "cpu" is asked for; raises without CUDA); log: a
    callable taking each output line."""

    def __init__(self, dtype=torch.float64, device="cuda", log=None):
        self.root = "."
        self.dtype = dtype
        self.device = resolve_device(device)
        self.log = log or (lambda *a: None)

        self.variables: dict[str, str] = {}
        self._index_values: dict[str, list] = {}
        # equal-style variable EXPRESSIONS, evaluated lazily through
        # io/expr.py (the variable.cpp Variable::evaluate analog)
        self._equal_exprs: dict[str, str] = {}
        # internal-style variables' values (fix controller's cvar)
        self._internal_vars: dict[str, float] = {}
        # atom-style variables' expressions (evaluate_atom_expr), and the
        # world-style variables' value lists (world 0's value in
        # `variables`: one partition)
        self._atom_exprs: dict[str, str] = {}
        self._world_vars: dict[str, list] = {}
        self._eval_in_progress: set = set()
        self._rng_equal = None       # persistent random() streams
        self._rng_atom = None
        self._run_begin = 0          # update->beginstep/endstep analogs
        self._run_end = 0
        self._in_run = False
        self._skip_next_jump = False
        self.units = units_mod.LJ
        self.dt: float = self.units.dt
        # the neighbour skin and schedule (Neighbor::decide): the cell
        # grid's bin width is the largest cutoff plus the skin, rebuilt as
        # every/delay/check say (neighbor.cpp defaults every 1, delay 10,
        # check yes); the dense route and the panel engine take every pair
        self.skin: float = self.units.skin
        self.neigh_every = 1
        self.neigh_delay = 10
        self.neigh_check = True
        # neigh_modify exclude: same-molecule pairs (molecule/intra all)
        # and type pairs (type I J)
        self.neigh_exclude_mol = False
        self.neigh_exclude_types: list = []
        # exclude group A A: no pair with both atoms in A (the granular
        # route's alone, as in the JAX package)
        self.neigh_exclude_group = None
        self.atom_style = "atomic"
        # atom_style sphere's per-atom radius, mass and angular velocity
        # (read_data), and pair gran/*'s six settings
        self.radius = self.rmass = self.omega = None
        self.gran_args = None
        self.dimension = 3
        # boundary: each dimension's (lo, hi) face styles p, f, s or m;
        # the box create_box made, before the `s` faces' expansion (the
        # shrink-wrap's `small` and the `m` faces' limits)
        self.boundary_styles = [("p", "p")] * 3
        self._created_box = None
        self.data = None             # DataFile
        self.lattice_style = None
        self.lattice_spacing3 = None   # (3,) of the lattice command
        # region ID -> its arguments, in the region's units: the block's
        # (xlo, xhi, ylo, yhi, zlo, zhi), else (style, *args) and for
        # union and intersect (style, *sub-region IDs); region ID ->
        # {"side": in|out, "units": lattice|box}
        self.regions: dict[str, tuple] = {}
        self._region_kw: dict[str, dict] = {}
        # equal-style ramp(lo,hi) variables by name (fix adapt)
        self._ramp_vars: dict[str, tuple] = {}
        self.box_lo = None
        self.box_hi = None
        self.box_tilt = None
        self.x = None                # (N,3) numpy
        self.v = None
        self.q = None
        self.type = None
        self.mol = None
        self.image = None
        self.ntypes = 0
        self.mass_type = None        # (T+1,)
        self.alpha_type = None       # (T+1,)
        self._bonds = None
        self._bond_types = None
        self.nbondtypes = 0
        # the Angles / Dihedrals / Impropers sections ((M,k) 1-based atom
        # ids and their types), None without them
        self._angles = self._angle_types = None
        self._dihedrals = self._dihedral_types = None
        self._impropers = self._improper_types = None
        # the bonded styles: name, its arguments (hybrid: the sub-styles;
        # table: interpolation and N) and type -> coefficient list
        self.bond_style = self.angle_style = None
        self.dihedral_style = self.improper_style = None
        self.bond_style_args: list = []
        self.angle_style_args: list = []
        self.dihedral_style_args: list = []
        self.improper_style_args: list = []
        self.bond_coeffs: dict = {}
        self.angle_coeffs: dict = {}
        self.dihedral_coeffs: dict = {}
        self.improper_coeffs: dict = {}
        self.pair = PairStyleSpec()
        self.pair_coeffs: dict[tuple, tuple] = {}
        # the CHARMM styles' (eps14, sigma14) by type pair
        self.pair_coeffs14: dict[tuple, tuple] = {}
        # pair_style hybrid[/overlay]: (name, args) of each sub-style and
        # its raw pair_coeff rows (I token, J token, coefficient tokens or
        # None for `none`), replayed through the sub-style at build time
        self.pair_hybrid: list = []
        self.hybrid_raw_coeffs: list = []
        # the settings of the generic styles: coul/dsf|wolf's alpha,
        # coul/debye's kappa, yukawa's kappa, table's N, and dpd's
        # temperatures, seed and flavour
        self._dsf_alpha = 0.0
        self._debye_kappa = 0.0
        self._yukawa_kappa = 0.0
        self._table_n = 1000
        self._dpd = None
        # the EAM styles' potential file and, for eam/alloy and eam/fs,
        # the element name (None for NULL) of each type
        self.eam_file: Optional[str] = None
        self.eam_type_elems: Optional[list] = None
        self.kspace: Optional[tuple] = None      # (style, accuracy)
        # index 0 = factor for non-special pairs, always 1.0
        self.special_lj = [1.0, 0.0, 0.0, 0.0]
        self.special_coul = [1.0, 0.0, 0.0, 0.0]
        self.groups: dict[str, np.ndarray] = {}
        self.fixes: dict[str, FixSpec] = {}
        # compute ID -> (group, style); built into the Simulation
        self.computes: dict[str, tuple] = {}
        self.dumps: dict[str, DumpSpec] = {}
        self.thermo_every = 0
        self.thermo_columns = ["step", "temp", "epair", "emol", "etotal",
                               "press"]
        self.step = 0
        self.thermo_rows: list[dict] = []
        self._sim = None             # live Simulation between run commands
        self._pair_mix = "geometric"  # pair_modify mix
        self._pair_shift = False      # pair_modify shift
        self._pair_tail = False       # pair_modify tail
        self._gewald_override = None  # kspace_modify gewald
        self._gewald6_override = None  # kspace_modify gewald/disp
        self._msm_cutoff_adjust = True  # kspace_modify cutoff/adjust
        # lj/long/tip4p/long's LJ flag: long (the dispersion sum) or cut
        self._tip4p_lj_long = False
        self._thermo_norm = None
        self._thermo_float_format = None
        # thermo_modify temp ID: the temp compute the thermo temperature,
        # KE and pressure follow; fix_modify ID temp ID by fix
        self._thermo_temp = None
        self._fix_modify: dict = {}
        # fix cmap's crossterm rows (M,6) [map a1..a5] of read_data's CMAP
        # section, None without one
        self._crossterms = None
        # compute_modify by compute ID (thermo_temp: the thermo's)
        self._compute_modify: dict = {}
        # the thermo row while its v_NAME columns are evaluated, so that a
        # thermo keyword in the expression reads this row
        self._kw_row = None
        # the output fixes' results by fix ID (as the JAX package keeps
        # them): ave/time's (step, mean) pairs, ave/chunk's last (step,
        # rows), ave/histo's last histogram, ave/correlate's
        # (correlations, counts)
        self.ave_time_values: dict = {}
        self.ave_chunk_values: dict = {}
        self.ave_histo_values: dict = {}
        self.ave_correlate_values: dict = {}
        # rerun's frames: (rebuild ms, evaluation ms) each
        self.rerun_timings: list = []
        # min_style, min_modify dmax, and each minimize's (energy,
        # iterations, converged)
        self._min_style = "cg"
        self._min_modify: dict = {}
        self.minimized: list = []
        # dielectric: qqrd2e = qqr2e / dielectric (force.cpp)
        self.dielectric = 1.0
        # restart N file [file2]: the cadence, the names, which name is
        # next; read_restart's file (its dipoles and integrator state go
        # into the next run's setup); the run's later chunks print no
        # start row
        self._restart_every = 0
        self._restart_files: list = []
        self._restart_toggle = 0
        self._restart_state = None
        self._suppress_start_row = False
        # timer: its mode (full: the per-term breakdown after a run), the
        # wall-clock budget of a run in seconds, and every N
        self._timer_mode = "normal"
        self._timer_timeout = None
        self._timer_every = None
        # molecule templates by ID; balance's stored weights by name
        self.molecules: dict = {}
        self.balance_store: dict = {}

    # ------------------------------ parsing ------------------------------

    def file(self, path: str):
        self.root = os.path.dirname(os.path.abspath(path))
        with open(path) as fh:
            self.execute(fh.readlines())

    def execute(self, lines):
        """Run a command list with control flow (label/jump/next, the
        input.cpp commands).  Lines ending in '&' continue onto the next
        line (Input::parse)."""
        merged, buf = [], ""
        for line in lines:
            body = line.split("#", 1)[0].rstrip()
            if body.endswith("&"):
                buf += body[:-1] + " "
                continue
            merged.append(buf + line)
            buf = ""
        if buf:
            merged.append(buf)
        lines = merged
        pc = 0
        self._skip_next_jump = False
        while pc < len(lines):
            line = lines[pc]
            toks = line.split("#", 1)[0].strip().split()
            if toks and toks[0] == "label":
                pc += 1
                continue
            if toks and toks[0] == "jump":
                if self._skip_next_jump:
                    self._skip_next_jump = False
                    pc += 1
                    continue
                if toks[1] != "SELF":
                    _unported(f"jump {toks[1]} (jump SELF only)")
                pc = self._find_label(lines, toks[2] if len(toks) > 2
                                      else None)
                continue
            if toks and toks[0] == "next":
                name = toks[1]
                seq = self._index_values.get(name)
                if seq is not None and self.variables.get(name) in seq[:-1]:
                    i = seq.index(self.variables[name])
                    self.variables[name] = seq[i + 1]
                else:
                    self.variables.pop(name, None)
                    self._index_values.pop(name, None)
                    self._skip_next_jump = True
                pc += 1
                continue
            self.one(line)
            pc += 1

    @staticmethod
    def _find_label(lines, target):
        for i, line in enumerate(lines):
            toks = line.split("#", 1)[0].split()
            if len(toks) >= 2 and toks[0] == "label" and toks[1] == target:
                return i
        raise ValueError(f"label {target} not found")

    def one(self, line: str):
        line = line.split("#", 1)[0].strip()
        if not line:
            return
        line = self._substitute(line)
        toks = line.split()
        cmd, args = toks[0], toks[1:]
        handler = getattr(self, "cmd_" + cmd, None)
        if handler is None:
            _unported(f"command {cmd}")
        handler(args)

    def _substitute(self, line: str) -> str:
        out = []
        i = 0
        while i < len(line):
            c = line[i]
            if c == "$":
                if line[i + 1] == "(":
                    # $(expr) immediate evaluation (Input::substitute)
                    j = expr_mod._find_matching_paren(line, i + 1)
                    text = line[i + 2:j]
                    i = j + 1
                    out.append("%.20g" % self.evaluate_expr(text))
                    continue
                if line[i + 1] == "{":
                    j = line.index("}", i)
                    name = line[i + 2:j]
                    i = j + 1
                else:
                    name = line[i + 1]
                    i += 2
                s = self.var_str(name)
                if s is not None:
                    out.append(s)
                else:
                    out.append("${%s}" % name if len(name) > 1
                               else "$" + name)
            else:
                out.append(c)
                i += 1
        return "".join(out)

    # ------------------------- variable engine --------------------------

    def var_str(self, name) -> Optional[str]:
        """Variable::retrieve analog: the substitution string for $name —
        the equal and internal styles evaluate NOW and format %.15g
        (variable.cpp:856)."""
        if name in self._equal_exprs:
            return "%.15g" % self.var_value(name)
        if name in self._internal_vars:
            return "%.15g" % self._internal_vars[name]
        return self.variables.get(name)

    def var_value(self, name) -> float:
        """Numeric value of a variable (internal as set, equal evaluated
        lazily; index, loop and string parsed as numbers)."""
        if name in self._internal_vars:
            return self._internal_vars[name]
        if name in self._equal_exprs:
            if name in self._eval_in_progress:
                raise ValueError(
                    f"variable {name} has a circular dependency")
            self._eval_in_progress.add(name)
            try:
                return self.evaluate_expr(self._equal_exprs[name])
            finally:
                self._eval_in_progress.discard(name)
        if name in self.variables:
            return float(self.variables[name])
        raise KeyError(f"variable {name} is not defined")

    def evaluate_expr(self, text: str) -> float:
        return expr_mod.evaluate(_ExprCtx(self), text)

    def evaluate_atom_expr(self, text: str) -> np.ndarray:
        """An atom-style formula over the host's atoms: (natoms,) float."""
        return expr_mod.evaluate_atom(_ExprCtx(self), text)

    def _thermo_keyword(self, word):
        """Thermo::evaluate_keyword analog for expressions: geometry and
        configuration keywords from the host state, state keywords from
        the live Simulation's thermo row."""
        if self._kw_row is not None and isinstance(
                self._kw_row.get(word), (int, float)):
            return float(self._kw_row[word])
        if word == "step":
            return float(self.step)
        if word == "dt":
            return float(self.dt)
        if word == "time":
            return float(self.step) * float(self.dt)
        if word in ("elapsed", "elaplong"):
            return float(self.step - self._run_begin)
        if word == "atoms":
            return float(len(self.x) if self.x is not None else 0)
        if word in ("cpu", "tpcpu", "spcpu", "cpuremain", "part",
                    "timeremain"):
            return 0.0
        if self.box_lo is not None:
            lo, hi = self.box_lo, self.box_hi
            L = hi - lo
            geom = {"lx": L[0], "ly": L[1], "lz": L[2],
                    "xlo": lo[0], "xhi": hi[0], "ylo": lo[1],
                    "yhi": hi[1], "zlo": lo[2], "zhi": hi[2],
                    "vol": L[0] * L[1] * L[2], "xy": 0.0, "xz": 0.0,
                    "yz": 0.0}
            if word in geom:
                return float(geom[word])
        if word == "bonds":
            return 0.0 if self._bonds is None else float(len(self._bonds))
        row = self._current_thermo_row()
        if row is not None and word in row:
            return float(row[word])
        return None

    def _current_thermo_row(self):
        """Thermo row for the CURRENT state (between runs this is the last
        force evaluation — the reference's staleness)."""
        if self._kw_row is not None:
            return self._kw_row
        if self._sim is not None and self._sim.res is not None:
            return self._sim.thermo_row()
        return None

    # ----------------------------- commands ------------------------------

    def cmd_print(self, a):
        self.log(" ".join(a).strip('"'))

    def cmd_include(self, a):
        with open(os.path.join(self.root, a[0])) as fh:
            self.execute(fh.readlines())

    def cmd_if(self, a):
        """if "cond" then "cmd"... [elif "cond" "cmd"...]* [else "cmd"...]
        (input.cpp:905-1010; conditions through the Boolean evaluator,
        variable.cpp:4629)."""
        toks = shlex.split(" ".join(a))
        if "then" not in toks:
            raise ValueError("if command needs 'then'")
        branches = []
        cond = toks[0]
        cmds = []
        i = toks.index("then") + 1
        while i < len(toks):
            t = toks[i]
            if t == "elif":
                branches.append((cond, cmds))
                cond, cmds = toks[i + 1], []
                i += 2
                continue
            if t == "else":
                branches.append((cond, cmds))
                cond, cmds = None, []
                i += 1
                continue
            cmds.append(t)
            i += 1
        branches.append((cond, cmds))
        for cond, cmds in branches:
            if cond is None or expr_mod.evaluate_boolean(cond) != 0.0:
                for c in cmds:
                    self.one(c)
                return

    def cmd_variable(self, a):
        name, style = a[0], a[1]
        if style == "index":
            # a value set before (the CLI's -var) wins
            if name not in self.variables:
                self.variables[name] = a[2]
                self._index_values[name] = list(a[2:])
        elif style == "loop":
            if name not in self.variables:
                vals = [str(i) for i in range(1, int(a[2]) + 1)]
                self.variables[name] = vals[0]
                self._index_values[name] = vals
        elif style == "delete":
            for d in (self.variables, self._index_values,
                      self._equal_exprs, self._atom_exprs,
                      self._internal_vars):
                d.pop(name, None)
        elif style == "equal":
            # the EXPRESSION is stored; evaluation is lazy, so thermo
            # keywords see the state at use time; redefinition replaces
            expr = " ".join(a[2:]).strip()
            if (expr.startswith('"') and expr.endswith('"')) or (
                    expr.startswith("'") and expr.endswith("'")):
                expr = expr[1:-1]
            self._equal_exprs[name] = expr
            self.variables.pop(name, None)
            m_ramp = _RAMP_RE.match(expr)
            if m_ramp:
                # a ramp(lo,hi) of constants: fix adapt's prefactor ramp
                # reads its bounds (the JAX package's _ramp_vars)
                self._ramp_vars[name] = (float(m_ramp.group(1)),
                                         float(m_ramp.group(2)))
            else:
                self._ramp_vars.pop(name, None)
        elif style == "string":
            self.variables[name] = a[2]
        elif style == "internal":
            # a number code sets (variable.cpp INTERNAL): fix controller
            # writes its control variable here
            self._internal_vars[name] = float(a[2])
        elif style == "atom":
            # a per-atom expression, evaluated at use (evaluate_atom_expr)
            expr = " ".join(a[2:]).strip()
            if (expr.startswith('"') and expr.endswith('"')) or (
                    expr.startswith("'") and expr.endswith("'")):
                expr = expr[1:-1]
            self._atom_exprs[name] = expr
        elif style == "world":
            # one value a partition (variable.cpp WORLD): one partition
            # takes world 0's, the list is kept (the JAX package's
            # emulation, ROADMAP queue 3 item 60)
            self._world_vars[name] = list(a[2:])
            self.variables[name] = a[2]
        else:
            _unported(f"variable style {style}")

    def cmd_units(self, a):
        self.units = units_mod.get(a[0])
        self.dt = self.units.dt        # units resets dt (update.cpp:147 etc.)
        self.skin = self.units.skin

    def cmd_timestep(self, a):
        self.dt = float(a[0])

    def cmd_boundary(self, a):
        """boundary X Y Z, each p, f, s or m or a two-letter per-face form
        (domain.cpp:418-460); p takes both faces of a dimension."""
        styles = []
        for tok in a[:3]:
            tok = tok if len(tok) == 2 else tok + tok
            for c in tok:
                if c not in "pfsm":
                    raise ValueError(f"illegal boundary style {tok!r}")
            if "p" in tok and tok != "pp":
                raise ValueError("both faces of a dim must be periodic")
            styles.append((tok[0], tok[1]))
        while len(styles) < 3:
            styles.append(("p", "p"))
        self.boundary_styles = styles

    @property
    def periodic(self):
        return tuple(st == ("p", "p") for st in self.boundary_styles)

    def _apply_initial_box(self):
        """Domain::set_initial_box (domain.cpp:204-224): the created box
        kept for the shrink-wrap, and each `s` face moved outward by small
        = 1e-4 of the created length."""
        self._created_box = (self.box_lo.copy(), self.box_hi.copy())
        small = 1.0e-4 * (self.box_hi - self.box_lo)
        for d, (lo_s, hi_s) in enumerate(self.boundary_styles):
            if lo_s == "s":
                self.box_lo[d] -= small[d]
            if hi_s == "s":
                self.box_hi[d] += small[d]

    def cmd_atom_style(self, a):
        # bond, angle and molecular read `id mol type x y z` (no charge)
        if a[0] not in ("atomic", "full", "charge", "bond", "angle",
                        "molecular", "sphere"):
            _unported(f"atom_style {a[0]} (atomic, charge, bond, angle, "
                      "molecular, full and sphere only)", _FRONT_END)
        self.atom_style = a[0]

    def cmd_dimension(self, a):
        """dimension 2|3: a 2d run keeps its atoms on the z = 0 plane
        (create_atoms), takes dim*N - dim dof and the area as its volume
        in the pressure and the vol column; fix enforce2d zeroes f_z."""
        if a[0] not in ("2", "3"):
            raise ValueError("dimension must be 2 or 3")
        self.dimension = int(a[0])

    def cmd_processors(self, a):
        if any(tok not in ("1", "*") for tok in a[:3]):
            _unported(f"processors {' '.join(a)} (one device; multi-GPU "
                      "is ROADMAP queue 1 item 7)")

    def cmd_atom_modify(self, a):
        # map array|hash / sort: global-ID lookup is an array index and
        # the panel engine needs no sort
        pass

    def cmd_log(self, a):
        pass

    def cmd_echo(self, a):
        pass

    def cmd_newton(self, a):
        pass

    def cmd_comm_modify(self, a):
        pass

    def cmd_neighbor(self, a):
        # neighbor SKIN STYLE: the binning style sizes nothing here
        self.skin = float(a[0])

    def cmd_neigh_modify(self, a):
        """neigh_modify every N | delay N | check yes/no | one N | page N |
        exclude molecule|molecule/intra all | exclude type I J | exclude
        group A A (neighbor.cpp modify_params); one and page size the
        reference's list pages, which the cell grid does not have.  An
        excluded pair takes no pair term (the JAX package masks it out of
        every pair pass); exclude group holds on the granular route alone
        (sim.py raises elsewhere), exclude group A B and the exclusions on
        a sub-group raise."""
        i = 0
        while i < len(a):
            k = a[i]
            if k == "exclude":
                kind = a[i + 1]
                if kind in ("molecule", "molecule/intra"):
                    # molecule was renamed molecule/intra in 2018
                    # (neighbor.cpp:2305)
                    if a[i + 2] != "all":
                        _unported(f"neigh_modify exclude {kind} on a "
                                  "sub-group", _BREADTH)
                    self.neigh_exclude_mol = True
                    i += 3
                elif kind == "type":
                    self.neigh_exclude_types.append(
                        (int(a[i + 2]), int(a[i + 3])))
                    i += 4
                elif kind == "group":
                    # in.chute's bottom bottom (the JAX package's form)
                    if a[i + 2] != a[i + 3]:
                        _unported("neigh_modify exclude group A B with A != "
                                  "B", _BREADTH)
                    self.neigh_exclude_group = a[i + 2]
                    i += 4
                else:
                    _unported(f"neigh_modify exclude {kind}", _BREADTH)
                self._invalidate()
                continue
            if k == "every":
                self.neigh_every = int(a[i + 1])
            elif k == "delay":
                self.neigh_delay = int(a[i + 1])
            elif k == "check":
                self.neigh_check = _yesno(a[i + 1])
            elif k not in ("one", "page"):
                _unported(f"neigh_modify {k}", _BREADTH)
            i += 2

    # ------------------------- lattice and regions -------------------------

    def cmd_lattice(self, a):
        """lattice STYLE SCALE (lattice.cpp): fcc, bcc, sc and the 2d
        styles of lattice.py; in lj units SCALE is the reduced density."""
        from lidp_tpu_torch import lattice as lattice_mod

        if a[0] not in lattice_mod._BASES or len(a) != 2:
            _unported(f"lattice {' '.join(a)} (fcc, bcc, sc, sq, sq2 or hex "
                      "with a scale and no keywords)", _BREADTH)
        self.lattice_style = a[0]
        self.lattice_spacing3 = lattice_mod.lattice_spacing3(
            a[0], float(a[1]), self.units.name, dim=self.dimension)
        self.log("Lattice spacing in x,y,z = %g %g %g" % tuple(
            self.lattice_spacing3))

    def _spacing3(self):
        """The lattice spacings, 1 without a lattice command."""
        if self.lattice_spacing3 is None:
            return np.ones(3)
        return np.asarray(self.lattice_spacing3, float)

    # the arguments of each region style (region_*.cpp)
    _REGION_NARGS = {"block": 6, "sphere": 4, "prism": 9, "cylinder": 6,
                     "cone": 7, "plane": 6}

    def cmd_region(self, a):
        """region ID STYLE args [side in|out] [units lattice|box]
        (region.cpp options; region_block, sphere, cylinder, cone, plane,
        prism, union and intersect.cpp).  INF and -INF bounds stand for
        no bound.  A prism takes no membership test (the JAX package's
        has none) and makes no box: the port's box is orthogonal."""
        name, style = a[0], a[1]
        if style in ("union", "intersect"):
            cnt = int(a[2])
            subs = a[3:3 + cnt]
            for sub in subs:
                if sub not in self.regions:
                    raise ValueError(f"region {name}: region {sub} does "
                                     "not exist")
            tail = a[3 + cnt:]
            self.regions[name] = (style,) + tuple(subs)
        elif style in self._REGION_NARGS:
            k = self._REGION_NARGS[style]
            toks = a[2:2 + k]
            if len(toks) != k:
                raise ValueError(f"Illegal region {style} command")
            if style in ("cylinder", "cone"):
                if toks[0] not in ("x", "y", "z"):
                    raise ValueError(f"Illegal region {style} axis")
                vals = [toks[0]] + [float(v) for v in toks[1:]]
            else:
                vals = [float(v) for v in toks]
            tail = a[2 + k:]
            self.regions[name] = (tuple(vals) if style == "block"
                                  else (style,) + tuple(vals))
        else:
            _unported(f"region style {style}", _BREADTH)
        kw = {"side": "in", "units": "lattice"}
        i = 0
        while i < len(tail):
            if tail[i] == "side" and tail[i + 1:i + 2] in (["in"], ["out"]):
                kw["side"] = tail[i + 1]
            elif tail[i] == "units" and tail[i + 1:i + 2] in (["lattice"],
                                                           ["box"]):
                kw["units"] = tail[i + 1]
            else:
                _unported(f"region keyword {' '.join(tail[i:i + 2])}",
                          _BREADTH)
            i += 2
        self._region_kw[name] = kw

    def _region_spacing(self, name):
        """The scale of a region's arguments: 1 in box units, else the
        lattice spacings."""
        return (np.ones(3) if self._region_kw[name]["units"] == "box"
                else self._spacing3())

    def _region_mask(self, name, x=None):
        """Which of the points x (the host's x by default) lie in region
        `name`: bounds inclusive (Region::match through each style's
        inside()), side out inverting, union and intersect through their
        sub-regions, as the JAX package's _region_mask tests them."""
        r = self.regions[name]
        s3 = self._region_spacing(name)
        if x is None:
            x = self.x
        n = x.shape[0]
        if not isinstance(r[0], str):
            lo_hi = np.asarray(r, float) * np.repeat(s3, 2)
            sel = np.ones(n, bool)
            for d in range(3):
                # INF as a lower bound is minus infinity
                lo = -np.inf if np.isinf(lo_hi[2 * d]) else lo_hi[2 * d]
                sel &= (x[:, d] >= lo) & (x[:, d] <= lo_hi[2 * d + 1])
        elif r[0] == "sphere":
            c = np.array(r[1:4]) * s3
            rad = r[4] * s3[0]
            d = x - c
            sel = np.sum(d * d, axis=1) <= rad * rad
        elif r[0] in ("cylinder", "cone"):
            # the axis dim, the centre c1, c2 in the two other dims; a
            # cone's radius goes linearly from radlo to radhi along it
            dim = "xyz".index(r[1])
            d1, d2 = [d for d in range(3) if d != dim]
            c1, c2 = r[2] * s3[d1], r[3] * s3[d2]
            rs = s3[(dim + 1) % 3]
            lo, hi = (r[5], r[6]) if r[0] == "cylinder" else (r[6], r[7])
            lo, hi = lo * s3[dim], hi * s3[dim]
            if np.isinf(lo):
                lo = -np.inf
            if r[0] == "cylinder":
                rad = r[4] * rs
            else:
                t = np.clip((x[:, dim] - lo) / max(hi - lo, 1e-300), 0.0,
                            1.0)
                rad = r[4] * rs + t * (r[5] * rs - r[4] * rs)
            dd = (x[:, d1] - c1) ** 2 + (x[:, d2] - c2) ** 2
            sel = (dd <= rad * rad) & (x[:, dim] >= lo) & (x[:, dim] <= hi)
        elif r[0] == "plane":
            # inside: the side the normal points to
            p = np.array(r[1:4]) * s3
            sel = (x - p) @ np.array(r[4:7]) >= 0.0
        elif r[0] == "union":
            sel = np.zeros(n, bool)
            for sub in r[1:]:
                sel |= self._region_mask(sub, x)
        elif r[0] == "intersect":
            sel = np.ones(n, bool)
            for sub in r[1:]:
                sel &= self._region_mask(sub, x)
        else:
            raise ValueError(f"region {name}: no membership test for {r[0]}")
        return ~sel if self._region_kw[name]["side"] == "out" else sel

    def cmd_create_box(self, a):
        """create_box N region-ID (create_box.cpp), orthogonal: the box of
        the block scaled by the lattice spacings, as the JAX package's
        create_box scales it whatever the region's units (ROADMAP queue 3
        item 6); then Domain::set_initial_box (_apply_initial_box)."""
        for i in range(2, len(a), 2):
            # the topology counts and per-atom extras: the JAX package
            # accepts them and reads none (ROADMAP queue 3 item 61)
            if a[i] not in _CREATE_BOX_KEYWORDS or i + 1 >= len(a):
                _unported(f"create_box keyword {' '.join(a[i:i + 2])}",
                          _BREADTH)
            int(a[i + 1])
        r = self.regions[a[1]]
        if isinstance(r[0], str):
            if r[0] == "prism":
                _unported("a triclinic box (create_box of a prism)",
                          _TRICLINIC)
            raise ValueError("Create_box region must be of type block or "
                             "prism")
        self.ntypes = int(a[0])
        b = np.asarray(r, float)
        s3 = self._spacing3()
        self.box_lo = b[0::2] * s3
        self.box_hi = b[1::2] * s3
        self.box_tilt = None
        self._apply_initial_box()
        self.mass_type = np.zeros(self.ntypes + 1)
        self.alpha_type = np.zeros(self.ntypes + 1)

    def cmd_create_atoms(self, a):
        """create_atoms TYPE box | region ID | single x y z | random N SEED
        REGION-ID|NULL [units box|lattice] [mol ID SEED]
        (create_atoms.cpp styles BOX, REGION, SINGLE, RANDOM): lattice
        sites in the order of lattice.create_atoms_bounds, the order the
        `velocity ... loop all` stream follows; random draws of one
        RanPark stream in the box, kept where the region holds them
        (create_atoms.cpp:436).  With mol, a randomly rotated copy of the
        template at each site (_insert_molecules).  `box` replaces the
        atoms; the other styles, and mol, append to them."""
        from lidp_tpu_torch import lattice as lattice_mod
        from lidp_tpu_torch.rng import RanPark

        ty = int(a[0])
        npos = {"box": 2, "region": 3, "single": 5, "random": 5}
        if a[1] not in npos:
            _unported(f"create_atoms {a[1]}", _BREADTH)
        rest = a[npos[a[1]]:]
        units, mol = "lattice", None
        i = 0
        while i < len(rest):
            if rest[i] == "units" and a[1] == "single" and i + 1 < len(
                    rest) and rest[i + 1] in ("box", "lattice"):
                units = rest[i + 1]
                i += 2
            elif rest[i] == "mol" and i + 2 < len(rest):
                mol = (rest[i + 1], int(rest[i + 2]))
                if mol[0] not in self.molecules:
                    raise ValueError(f"Molecule template ID {mol[0]} for "
                                     "create_atoms does not exist")
                i += 3
            else:
                _unported(f"create_atoms keywords {' '.join(rest[i:])}",
                          _BREADTH)
        if a[1] in ("box", "region"):
            if self.lattice_style is None:
                raise ValueError("create_atoms: a lattice must be defined "
                                 "first")
            x = lattice_mod.create_atoms_bounds(
                self.lattice_style, self._spacing3(), self.box_lo,
                self.box_hi)
            if a[1] == "region":
                x = x[self._region_mask(a[2], x)]
            if self.dimension == 2:
                # the sites of the z = 0 plane, z set to exactly 0
                x = x[np.abs(x[:, 2]) < 1e-12]
                x[:, 2] = 0.0
        elif a[1] == "single":
            s3 = np.ones(3) if units == "box" else self._spacing3()
            x = np.array([[float(a[2]) * s3[0], float(a[3]) * s3[1],
                           float(a[4]) * s3[2]]])
        else:
            nrand, region = int(a[2]), a[4]
            lo, hi = self.box_lo.copy(), self.box_hi.copy()
            rng = RanPark(int(a[3]))
            pts = []
            while len(pts) < nrand:
                p = np.array([lo[0] + rng.uniform() * (hi[0] - lo[0]),
                              lo[1] + rng.uniform() * (hi[1] - lo[1]),
                              lo[2] + rng.uniform() * (hi[2] - lo[2])])
                if self.dimension == 2:
                    p[2] = 0.0
                if region != "NULL" and not self._region_mask(
                        region, p[None, :])[0]:
                    continue
                pts.append(p)
            x = np.asarray(pts).reshape(-1, 3)
        if mol is not None:
            self._insert_molecules(x, ty, mol[0], mol[1])
            return
        self.log(f"Created {x.shape[0]} atoms")
        nnew = x.shape[0]
        if self.x is not None and len(self.x) and a[1] != "box":
            self._invalidate()
            self.x = np.concatenate([self.x, x])
            self.v = np.concatenate([self.v, np.zeros((nnew, 3))])
            self.q = np.concatenate([self.q, np.zeros(nnew)])
            self.type = np.concatenate(
                [self.type, np.full(nnew, ty, np.int32)])
            self.mol = np.concatenate([self.mol, np.zeros(nnew, np.int32)])
            self.image = np.concatenate(
                [self.image, np.zeros((nnew, 3), np.int32)])
            self.groups = {k: np.concatenate(
                [np.asarray(v), np.full(nnew, k == "all", bool)])
                for k, v in self.groups.items()}
            return
        self._sim = None
        self.x = x
        self.v = np.zeros((nnew, 3))
        self.q = np.zeros(nnew)
        self.type = np.full(nnew, ty, np.int32)
        self.mol = np.zeros(nnew, np.int32)
        self.image = np.zeros((nnew, 3), np.int32)
        self._bonds = np.zeros((0, 2), np.int64)
        self._bond_types = None
        self.groups["all"] = np.ones(nnew, bool)

    def cmd_read_data(self, a):
        """read_data FILE [fix ID HEADER SECTION ...] (read_data.cpp): the
        fix keyword hands a section to a fix; fix cmap's `crossterm CMAP`
        is the one the port takes (the reader finds the CMAP section and
        the crossterms header by name, as the JAX package's does)."""
        rest = list(a[1:])
        while rest:
            if (len(rest) < 4 or rest[0] != "fix"
                    or rest[1] not in self.fixes
                    or self.fixes[rest[1]].style != "cmap"
                    or rest[2:4] != ["crossterm", "CMAP"]):
                _unported(f"read_data keywords {' '.join(rest)}")
            rest = rest[4:]
        d = read_data(os.path.join(self.root, a[0]),
                      atom_style=self.atom_style)
        if d.tilt is not None and np.any(d.tilt != 0.0):
            _unported("a triclinic box", _TRICLINIC)
        self.data = d
        self.ntypes = d.ntypes
        self.box_lo, self.box_hi = d.box_lo, d.box_hi
        self.box_tilt = d.tilt
        self.x, self.q = d.x, d.q
        self.type, self.mol, self.image = d.type, d.mol, d.image
        self.v = d.v if d.v is not None else np.zeros_like(d.x)
        # atom_style sphere: per-atom radius, mass and omega
        self.radius, self.rmass, self.omega = d.radius, d.rmass, d.omega
        self.mass_type = (d.mass if d.mass is not None
                          else np.zeros(d.ntypes + 1))
        self.alpha_type = np.zeros(d.ntypes + 1)
        self._bonds = d.bonds
        self._bond_types = d.bond_types
        self.nbondtypes = d.nbondtypes
        self._angles, self._angle_types = d.angles, d.angle_types
        self._dihedrals, self._dihedral_types = d.dihedrals, d.dihedral_types
        self._impropers, self._improper_types = d.impropers, d.improper_types
        if d.crossterms is not None:
            self._crossterms = d.crossterms
        self.groups["all"] = np.ones(d.natoms, bool)
        # the coeff sections of the data file (read_data.cpp): Pair Coeffs
        # rows are per type (i == i); the CHARMM styles carry eps14 and
        # sigma14 as columns 3-4
        for t, vals in (d.pair_coeffs or {}).items():
            self.pair_coeffs[(t, t)] = (vals[0], vals[1],
                                        self.pair.cut_lj_global)
            if len(vals) >= 4 and "charmm" in self.pair.name:
                self.pair_coeffs14[(t, t)] = (vals[2], vals[3])
        for fam in ("bond", "angle", "dihedral", "improper"):
            self.__dict__[f"{fam}_coeffs"].update(
                getattr(d, f"{fam}_coeffs") or {})

    def cmd_replicate(self, a):
        """Replicate the system nx x ny x nz (replicate.cpp: each atom
        unmapped through its image flags, shifted by box vectors, molecule
        ids and bonds offset per replica; positions stay unwrapped, image
        flags 0)."""
        nx, ny, nz = int(a[0]), int(a[1]), int(a[2])
        if min(nx, ny, nz) < 1:
            raise ValueError("Illegal replicate command: factors must be >= 1")
        if len(a) > 3:
            _unported(f"replicate keywords {' '.join(a[3:])}")
        if self._crossterms is not None:
            # the JAX package replicates the atoms and keeps the CMAP rows
            # of the first copy
            _unported("replicate with fix cmap's crossterms (the JAX "
                      "package keeps the first copy's rows)", _CMAP_ITEM)
        L = self.box_hi - self.box_lo
        n0 = self.x.shape[0]
        maxmol = int(self.mol.max()) if self.mol.size else 0
        xu = self.x + self.image * L
        xs, vs, qs, ts, ms, ims, bonds = [], [], [], [], [], [], []
        rep = 0
        for iz in range(nz):
            for iy in range(ny):
                for ix in range(nx):
                    xs.append(xu + np.array([ix, iy, iz]) * L)
                    vs.append(self.v)
                    qs.append(self.q)
                    ts.append(self.type)
                    ms.append(np.where(self.mol > 0,
                                       self.mol + rep * maxmol, 0))
                    ims.append(np.zeros_like(self.image))
                    if self._bonds is not None and len(self._bonds):
                        bonds.append(self._bonds + rep * n0)
                    rep += 1
        self.x = np.concatenate(xs)
        self.v = np.concatenate(vs)
        self.q = np.concatenate(qs)
        self.type = np.concatenate(ts).astype(np.int32)
        self.mol = np.concatenate(ms).astype(np.int32)
        self.image = np.concatenate(ims)
        self._bonds = (np.concatenate(bonds) if bonds
                       else np.zeros((0, 2), np.int64))
        if self._bond_types is not None and len(self._bonds):
            self._bond_types = np.tile(self._bond_types, rep)
        # replicate.cpp copies every topology section with per-replica
        # atom-index offsets
        for sec in ("angle", "dihedral", "improper"):
            arr = getattr(self, f"_{sec}s")
            if arr is not None and len(arr):
                setattr(self, f"_{sec}s", np.concatenate(
                    [arr + r * n0 for r in range(rep)]))
                setattr(self, f"_{sec}_types",
                        np.tile(getattr(self, f"_{sec}_types"), rep))
        self.box_hi = self.box_lo + L * np.array([nx, ny, nz])
        self.groups = {"all": np.ones(self.x.shape[0], bool)}
        self._invalidate()

    def _invalidate(self):
        """Adopt the live Simulation's evolved state (positions,
        velocities, image flags, box) into the host arrays, then drop it:
        a configuration change rebuilds the Simulation from them."""
        sim = self._sim
        self._sim = None
        if sim is None or sim.res is None:
            return
        n = sim.natoms

        def host(t):
            return t[:n].cpu().numpy().copy()

        self.x = host(sim.sys.x)
        self.v = host(sim.sys.v)
        self.image = host(sim.sys.image)
        self.box_lo = sim.sys.box.lo.cpu().numpy().copy()
        self.box_hi = sim.sys.box.hi.cpu().numpy().copy()

    def cmd_mass(self, a):
        # mass {type|wildcard} value (mass.cpp via utils::bounds)
        tok = str(a[0])
        if "*" in tok:
            lo, _, hi = tok.partition("*")
            lo = int(lo) if lo else 1
            hi = int(hi) if hi else self.ntypes
            for t in range(lo, hi + 1):
                self.mass_type[t] = float(a[1])
        else:
            self.mass_type[int(tok)] = float(a[1])

    def cmd_set(self, a):
        self._invalidate()
        if a[0] == "type" and a[2] == "static_polarizability":
            val = float(a[3])
            if val < 0:
                raise ValueError(
                    "static_polarizability must be >= 0 (set.cpp:178)")
            self.alpha_type[int(a[1])] = val
        elif a[2] == "charge":
            # set group|type|atom X charge Q (set.cpp CHARGE)
            self.q = np.where(self._set_selector(a[0], a[1]), float(a[3]),
                              self.q)
        elif a[2] == "mol":
            self.mol = np.where(self._set_selector(a[0], a[1]), int(a[3]),
                                self.mol)
        elif a[2] == "type/fraction":
            # set type|group X type/fraction newtype frac seed (set.cpp
            # :947): a RanPark stream per atom, reset from the seed and its
            # coordinates, one uniform; <= frac switches the type
            from lidp_tpu_torch.rng import park_geom_streams

            if a[0] not in ("type", "group"):
                _unported(f"set selector {a[0]} with type/fraction",
                          _BREADTH)
            newtype, frac, seed = int(a[3]), float(a[4]), int(a[5])
            hit = self._set_selector(a[0], a[1]) & (
                park_geom_streams(seed, self.x).uniform() <= frac)
            self.type = np.where(hit, newtype, self.type).astype(np.int32)
        elif a[2] == "type" and len(a) == 4:
            # set group|type|region|atom X type N (set.cpp TYPE)
            self.type = np.where(self._set_selector(a[0], a[1]), int(a[3]),
                                 self.type).astype(np.int32)
        else:
            _unported(f"set {' '.join(a)}", _BREADTH)

    def _set_selector(self, style, ident):
        """set.cpp selection styles: atom (id range), type, group, region."""
        n = len(self.x)
        if style == "group":
            return self.groups[ident].copy()
        if style == "type":
            return self.type == int(ident)
        if style == "region":
            return self._region_mask(ident)
        if style == "atom":
            ids = np.arange(1, n + 1)
            if "*" in ident:
                lo, _, hi = ident.partition("*")
                m = np.ones(n, bool)
                if lo:
                    m &= ids >= int(lo)
                if hi:
                    m &= ids <= int(hi)
                return m
            return ids == int(ident)
        _unported(f"set selector {style}", _BREADTH)

    def cmd_pair_style(self, a):
        """pair_style lj/cut CUT | lj/cut/coul/long CUT [CUT_COUL] |
        lj/cut/coul/long/polarization CUT [CUT_COUL] [keywords] |
        lj/charmm/coul/long, lj/charmmfsw/coul/long and
        lj/charmmfsw/coul/charmmfsh INNER OUTER [CUT_COUL] |
        lj/charmm/coul/charmm and lj/charmm/coul/charmm/implicit INNER
        OUTER [INNER_COUL OUTER_COUL] (the CHARMM styles mix
        arithmetically, as the JAX package sets them) | hbond/dreiding/lj
        and hbond/dreiding/morse AP INNER OUTER ANGLE | eam | eam/alloy |
        eam/fs | the long-dispersion, TIP4P and coul/msm styles
        (_kspace_pair_style) | the generic styles, lj/cut/coul/cut|debye|
        dsf|wolf, table and dpd (_generic_pair_style) | hybrid and
        hybrid/overlay with their sub-styles (_hybrid_pair_style)."""
        self._invalidate()
        self.pair_coeffs = {}
        self.pair_coeffs14 = {}
        a = [PAIR_STYLE_ALIASES.get(a[0], a[0])] + list(a[1:])
        if a[0] not in PAIR_STYLES + EAM_STYLES + GRAN_STYLES:
            _unported(f"pair_style {a[0]}", _BREADTH)
        p = PairStyleSpec(name=a[0])
        if a[0] in GRAN_STYLES:
            # kn kt gamman gammat xmu dampflag
            # (pair_gran_hooke_history.cpp settings :343)
            if len(a) < 7:
                raise ValueError("Illegal pair_style command")
            if len(a) > 7:
                # limit_damping and the like: the JAX package reads the
                # six settings alone
                raise NotImplementedError(
                    f"pair_style {a[0]} {' '.join(a[7:])}: the six settings "
                    "alone (ROADMAP queue 3 item 25, keywords JAX skips)")
            self.gran_args = list(a[1:7])
            self.pair = p
            return
        if a[0] in ("hybrid", "hybrid/overlay"):
            self._hybrid_pair_style(a)
            self.pair = p
            return
        if a[0] in GENERIC_STYLES + LJ_COUL_STYLES + ("table", "dpd",
                                                       "dpd/tstat"):
            self._generic_pair_style(p, a)
            self.pair = p
            return
        if a[0] in ("lj/long/coul/long", "buck/long/coul/long",
                    "lj/long/tip4p/long", "lj/cut/coul/msm",
                    "lj/charmm/coul/msm") or a[0] in TIP4P_STYLES:
            self._kspace_pair_style(p, a)
            self.pair = p
            return
        if a[0] in EAM_STYLES:
            # no settings: the cutoff is the potential file's
            # (PairEAM::settings, pair_eam.cpp)
            if len(a) > 1:
                raise ValueError("Illegal pair_style command")
            self.pair = p
            return
        if a[0] in HBOND_STYLES:
            # ap inner outer angle (pair_hbond_dreiding_lj.cpp::settings
            # :303-311); the coefficient rows are kept raw
            # (ops/hbond.py make_hbond_params reads them)
            if len(a) != 5:
                raise ValueError("Illegal pair_style command")
            self._hbond_settings = (int(a[1]), float(a[2]), float(a[3]),
                                    float(a[4]))
            self.hbond_coeffs = []
            p.cut_lj_global = float(a[3])
            self.pair = p
            return
        p.cut_lj_global = float(a[1])
        if a[0] in ("lj/charmm/coul/long", "lj/charmmfsw/coul/long",
                    "lj/charmmfsw/coul/charmmfsh"):
            # inner outer [coul-outer] (pair_lj_charmm_coul_long.cpp and
            # pair_lj_charmmfsw_coul_*.cpp settings; the coulomb cutoff
            # the outer LJ one by default)
            if len(a) not in (3, 4):
                raise ValueError("Illegal pair_style command")
            p.cut_lj_inner = float(a[1])
            p.cut_lj_global = float(a[2])
            p.cut_coul = float(a[3]) if len(a) > 3 else p.cut_lj_global
            self._pair_mix = "arithmetic"
            self.pair = p
            return
        if a[0] in ("lj/charmm/coul/charmm",
                    "lj/charmm/coul/charmm/implicit"):
            # inner outer [inner-coul outer-coul]
            # (pair_lj_charmm_coul_charmm.cpp settings: 2 or 4 arguments)
            if len(a) not in (3, 5):
                raise ValueError("Illegal pair_style command")
            p.cut_lj_inner = float(a[1])
            p.cut_lj_global = float(a[2])
            if len(a) > 4:
                p.cut_coul_inner, p.cut_coul = float(a[3]), float(a[4])
            else:
                p.cut_coul_inner, p.cut_coul = p.cut_lj_inner, p.cut_lj_global
            self._pair_mix = "arithmetic"
            self.pair = p
            return
        if a[0] == "lj/cut":
            if len(a) > 2:
                raise ValueError("Illegal pair_style command")
            self.pair = p
            return
        has_cc = len(a) > 2 and bool(_NUM_RE.match(a[2]))
        p.cut_coul = float(a[2]) if has_cc else p.cut_lj_global
        i = 3 if has_cc else 2
        if a[0] == "lj/cut/coul/long" and i < len(a):
            raise ValueError("Illegal pair_style command")
        while i < len(a):
            k, v = a[i], a[i + 1]
            if k == "precision":
                p.polar_precision = float(v)
            elif k == "zodid":
                if p.polar_gs or p.polar_gs_ranked:
                    raise ValueError(
                        "Zodid doesn't work with polar_gs or "
                        "polar_gs_ranked")
                p.zodid = _yesno(v)
            elif k == "fixed_iteration":
                p.fixed_iteration = _yesno(v)
            elif k == "damp":
                p.polar_damp = float(v)
            elif k == "max_iterations":
                p.iterations_max = int(v)
            elif k == "damp_type":
                p.damping_type = v
            elif k == "polar_gs":
                if p.polar_gs_ranked:
                    raise ValueError(
                        "polar_gs and polar_gs_ranked are mutually exclusive")
                p.polar_gs = _yesno(v)
            elif k == "polar_gs_ranked":
                if p.polar_gs:
                    raise ValueError(
                        "polar_gs and polar_gs_ranked are mutually exclusive")
                p.polar_gs_ranked = _yesno(v)
            elif k == "polar_gamma":
                p.polar_gamma = float(v)
            elif k == "debug":
                p.debug = _yesno(v)
            elif k == "use_previous":
                p.use_previous = _yesno(v)
            else:
                raise ValueError(f"Illegal pair_style keyword {k}")
            i += 2
        self.pair = p

    def _hybrid_pair_style(self, a):
        """pair_style hybrid|hybrid/overlay S1 ARGS1 S2 ARGS2 ...
        (pair_hybrid.cpp::settings): each sub-style's arguments run to the
        next known style name; the DREIDING hydrogen bonds among them are
        pulled out at setup (sim.py), the rest built by
        styles/pair_builders.py."""
        subs = []
        i = 1
        while i < len(a):
            name = PAIR_STYLE_ALIASES.get(a[i], a[i])
            if name not in KNOWN_PAIR_STYLES:
                raise ValueError(f"unsupported hybrid sub-style {name}")
            i += 1
            args = []
            while i < len(a) and a[i] not in KNOWN_PAIR_STYLES:
                args.append(a[i])
                i += 1
            subs.append((name, args))
        self.pair_hybrid = subs
        self.hybrid_raw_coeffs = [[] for _ in subs]

    def _generic_pair_style(self, p, a):
        """The settings of the generic styles (the JAX package's
        script.py:1269-1390): CUT for morse, buck, gauss, soft, born,
        lj/expand, mie/cut, lj96/cut, lj/smooth/linear, beck, ufm, zero;
        CUT [CUT_COUL] for buck/coul/cut|long, born/coul/long|msm,
        buck/coul/msm and lj/cut/coul/cut; KAPPA CUT for yukawa; KAPPA
        CUT [CUT_COUL] for lj/cut/coul/debye; KAPPA CUT_COUL for
        coul/debye; ALPHA CUT_COUL for coul/dsf|wolf; ALPHA CUT [CUT_COUL]
        for lj/cut/coul/dsf|wolf and born/coul/dsf|wolf; CUT_COUL for
        coul/cut|long|msm; INNER OUTER for lj/smooth (OUTER optional), zbl
        and lj/gromacs; INNER OUTER [INNER_COUL OUTER_COUL] for
        lj/gromacs/coul/gromacs; none for lj/cubic; STYLE N for table
        (linear: every table is resampled on one linear grid); T CUT SEED
        for dpd, TSTART TSTOP CUT SEED for dpd/tstat."""
        name = a[0]
        if name in ("morse", "buck", "gauss", "soft", "born", "lj/expand",
                    "mie/cut", "lj96/cut", "lj/smooth/linear", "beck",
                    "ufm", "zero"):
            p.cut_lj_global = float(a[1])
        elif name in ("buck/coul/cut", "buck/coul/long", "born/coul/long",
                      "born/coul/msm", "buck/coul/msm", "lj/cut/coul/cut"):
            p.cut_lj_global = float(a[1])
            p.cut_coul = float(a[2]) if len(a) > 2 else p.cut_lj_global
        elif name == "yukawa":
            self._yukawa_kappa = float(a[1])
            p.cut_lj_global = float(a[2])
        elif name == "lj/cut/coul/debye":
            self._debye_kappa = float(a[1])
            p.cut_lj_global = float(a[2])
            p.cut_coul = float(a[3]) if len(a) > 3 else p.cut_lj_global
        elif name == "coul/debye":
            self._debye_kappa = float(a[1])
            p.cut_coul = float(a[2])
        elif name in ("coul/dsf", "coul/wolf"):
            self._dsf_alpha = float(a[1])
            p.cut_coul = float(a[2])
        elif name in ("lj/cut/coul/dsf", "lj/cut/coul/wolf",
                      "born/coul/dsf", "born/coul/wolf"):
            self._dsf_alpha = float(a[1])
            p.cut_lj_global = float(a[2])
            p.cut_coul = float(a[3]) if len(a) > 3 else p.cut_lj_global
        elif name in ("coul/cut", "coul/long", "coul/msm"):
            p.cut_coul = float(a[1])
        elif name == "lj/smooth":
            p.cut_lj_inner = float(a[1])
            p.cut_lj_global = float(a[2]) if len(a) > 2 else p.cut_lj_inner
        elif name in ("zbl", "lj/gromacs"):
            p.cut_lj_inner = float(a[1])
            p.cut_lj_global = float(a[2])
        elif name == "lj/gromacs/coul/gromacs":
            p.cut_lj_inner = float(a[1])
            p.cut_lj_global = float(a[2])
            if len(a) > 4:
                p.cut_coul_inner, p.cut_coul = float(a[3]), float(a[4])
            else:
                p.cut_coul_inner, p.cut_coul = p.cut_lj_inner, \
                    p.cut_lj_global
        elif name == "table":
            if a[1] != "linear":
                _unported(f"pair_style table {a[1]} (the JAX package "
                          "resamples it linearly)", _BREADTH)
            self._table_n = int(a[2])
        elif name == "dpd":
            self._dpd = dict(T=float(a[1]), Tstop=float(a[1]),
                             seed=int(a[3]), tstat=False)
            p.cut_lj_global = float(a[2])
        elif name == "dpd/tstat":
            self._dpd = dict(T=float(a[1]), Tstop=float(a[2]),
                             seed=int(a[4]), tstat=True)
            p.cut_lj_global = float(a[3])
        # lj/cubic: no settings (its cutoffs derive from sigma)

    def _kspace_pair_style(self, p, a):
        """The settings of the k-space breadth's pair styles (the JAX
        package's script.py:1197-1203, :1318-1383):
        lj/long/coul/long and buck/long/coul/long FLAG_LJ FLAG_COUL CUT
        [CUT_COUL], the flags `long long` only; lj/long/tip4p/long
        FLAG_LJ long OTYPE HTYPE BTYPE ATYPE QDIST CUT [CUT_COUL], FLAG_LJ
        cut or long; lj/cut/tip4p/long and lj/cut/tip4p/cut OTYPE HTYPE
        BTYPE ATYPE QDIST CUT [CUT_COUL]; tip4p/long and tip4p/cut OTYPE
        HTYPE BTYPE ATYPE QDIST CUT_COUL; lj/cut/coul/msm CUT [CUT_COUL];
        lj/charmm/coul/msm INNER OUTER [CUT_COUL], mixed
        arithmetically."""
        name = a[0]
        if name in ("lj/long/coul/long", "buck/long/coul/long"):
            if a[1] != "long" or a[2] != "long":
                raise NotImplementedError(
                    f"{name}: only 'long long' flags supported")
            p.cut_lj_global = float(a[3])
            p.cut_coul = float(a[4]) if len(a) > 4 else p.cut_lj_global
        elif name == "lj/long/tip4p/long":
            if a[2] != "long":
                raise NotImplementedError(
                    "lj/long/tip4p/long: coulomb flag must be 'long'")
            if a[1] not in ("cut", "long"):
                raise NotImplementedError(
                    "lj/long/tip4p/long: lj flag must be 'cut' or 'long'")
            self._tip4p_lj_long = a[1] == "long"
            p.tip4p = (int(a[3]), int(a[4]), int(a[5]), int(a[6]),
                       float(a[7]))
            p.cut_lj_global = float(a[8])
            p.cut_coul = float(a[9]) if len(a) > 9 else p.cut_lj_global
        elif name in ("lj/cut/tip4p/long", "lj/cut/tip4p/cut"):
            p.tip4p = (int(a[1]), int(a[2]), int(a[3]), int(a[4]),
                       float(a[5]))
            p.tip4p_mode = "cut" if name.endswith("/cut") else "long"
            p.cut_lj_global = float(a[6])
            p.cut_coul = float(a[7]) if len(a) > 7 else p.cut_lj_global
        elif name in ("tip4p/long", "tip4p/cut"):
            p.tip4p = (int(a[1]), int(a[2]), int(a[3]), int(a[4]),
                       float(a[5]))
            p.tip4p_mode = "cut" if name.endswith("/cut") else "long"
            p.cut_coul = float(a[6])
            p.cut_lj_global = 0.0   # no van der Waals term
        elif name == "lj/cut/coul/msm":
            p.cut_lj_global = float(a[1])
            p.cut_coul = float(a[2]) if len(a) > 2 else p.cut_lj_global
        else:   # lj/charmm/coul/msm
            p.cut_lj_inner = float(a[1])
            p.cut_lj_global = float(a[2])
            p.cut_coul = float(a[3]) if len(a) > 3 else p.cut_lj_global
            self._pair_mix = "arithmetic"

    def cmd_pair_coeff(self, a):
        self._invalidate()
        if self.pair.name in GRAN_STYLES:
            # the granular styles take no per-type coefficients
            # (PairGranHookeHistory::coeff, pair_gran_hooke_history.cpp:368)
            return
        if self.pair.name in EAM_STYLES:
            self._eam_coeff(a)
            return
        name = self.pair.name
        if name in HBOND_STYLES:
            # I J K i|j EPS|D0 SIGMA|ALPHA [R0] [AP [INNER OUTER [ANGLE]]]
            # (PairHbondDreidingLJ::coeff :317-384), kept raw
            self.hbond_coeffs.append(list(a))
            return
        if name in ("hybrid", "hybrid/overlay"):
            self._hybrid_coeff(a)
            return
        if name in ("tip4p/cut", "tip4p/long") or (
                name in _NCOEFF and name.startswith("coul")
                and a[0] == "*" and a[1] == "*"):
            return   # the coulomb-only styles take no coefficients
        if a[0] == "*" or a[1] == "*":
            # pair_coeff * * ... — wildcard ranges (Force::bounds)
            ii = range(1, self.ntypes + 1) if a[0] == "*" else [int(a[0])]
            jj = range(1, self.ntypes + 1) if a[1] == "*" else [int(a[1])]
            for i_ in ii:
                for j_ in jj:
                    if i_ <= j_:
                        self.cmd_pair_coeff([str(i_), str(j_)] + list(a[2:]))
            return
        i, j = int(a[0]), int(a[1])
        key = (min(i, j), max(i, j))
        if name == "table":
            # i j FILE KEYWORD [cutoff]
            r_t, e_t, f_t = _read_pair_table(os.path.join(self.root, a[2]),
                                             a[3])
            cut = float(a[4]) if len(a) > 4 else float(r_t[-1])
            self.pair_coeffs[key] = (("tablefile", r_t, e_t, f_t), 0.0,
                                     cut)
            return
        if name in _NCOEFF:
            nc = _NCOEFF[name]
            vals = tuple(float(v) for v in a[2:2 + nc])
            cut = (float(a[2 + nc]) if len(a) > 2 + nc
                   else self.pair.cut_lj_global)
            self.pair_coeffs[key] = vals + (cut,)
            return
        if name in ("lj/gromacs", "lj/smooth"):
            # i j eps sigma [inner outer]
            vals = (float(a[2]), float(a[3]))
            vals += ((float(a[4]), float(a[5])) if len(a) > 5
                     else (self.pair.cut_lj_global,))
            self.pair_coeffs[key] = vals
            return
        if self.pair.name == "buck/long/coul/long":
            # i j A rho C [cut] (pair_buck_long_coul_long.cpp::coeff)
            vals = tuple(float(v) for v in a[2:5])
            cut = float(a[5]) if len(a) > 5 else self.pair.cut_lj_global
            self.pair_coeffs[(min(i, j), max(i, j))] = vals + (cut,)
            return
        eps, sig = float(a[2]), float(a[3])
        if "charmm" in self.pair.name:
            # i j eps sigma [eps14 sigma14]; the cutoffs are global
            # (pair_lj_charmm_coul_long.cpp::coeff)
            if len(a) > 4:
                self.pair_coeffs14[(min(i, j), max(i, j))] = (
                    float(a[4]), float(a[5]))
            self.pair_coeffs[(min(i, j), max(i, j))] = (
                eps, sig, self.pair.cut_lj_global)
            return
        cut = float(a[4]) if len(a) > 4 else self.pair.cut_lj_global
        self.pair_coeffs[(min(i, j), max(i, j))] = (eps, sig, cut)

    def _hybrid_coeff(self, a):
        """pair_coeff I J SUBSTYLE [K] COEFFS... under hybrid
        (PairHybrid::coeff): the tokens are kept raw for the sub-style
        (the K-th of that name where it repeats); `pair_coeff I J none`
        drops the pair from every sub-style."""
        sub = a[2]
        if sub == "none":
            for store in self.hybrid_raw_coeffs:
                store.append((a[0], a[1], None))
            return
        sub = PAIR_STYLE_ALIASES.get(sub, sub)
        names = [n for n, _ in self.pair_hybrid]
        if sub not in names:
            raise ValueError(f"pair_coeff sub-style {sub} not in hybrid "
                             "list")
        rest = list(a[3:])
        k = names.index(sub)
        if names.count(sub) > 1:
            if not (rest and rest[0].isdigit()):
                raise ValueError(f"duplicate hybrid sub-style {sub} needs "
                                 "an index")
            k = [ix for ix, n in enumerate(names) if n == sub][
                int(rest[0]) - 1]
            rest = rest[1:]
        self.hybrid_raw_coeffs[k].append((a[0], a[1], rest))

    def _eam_coeff(self, a):
        """pair_coeff of the EAM styles (the JAX package's script.py
        :1430-1466).  eam: `I J file`, a funcfl file, whose header's mass
        every type without a `mass` takes (pair_eam.cpp coeff/read_file).
        eam/alloy, eam/fs: `* * file El1 ... ElN`, a setfl file and one
        element name or NULL per type (pair_eam_alloy.cpp::coeff,
        pair_eam_fs.cpp::coeff), each named type without a mass taking its
        element's."""
        from lidp_tpu_torch.ops.eam import read_funcfl, read_setfl

        name = self.pair.name
        if self.mass_type is None:
            self.mass_type = np.zeros(self.ntypes + 1)
        if name == "eam":
            self.eam_file = os.path.join(self.root, a[2])
            mass = read_funcfl(self.eam_file)["mass"]
            for t in range(1, self.ntypes + 1):
                if self.mass_type[t] == 0.0:
                    self.mass_type[t] = mass
            return
        if a[0] != "*" or a[1] != "*":
            raise ValueError(f"{name} pair_coeff must be * *")
        self.eam_file = os.path.join(self.root, a[2])
        names = a[3:3 + self.ntypes]
        if len(names) != self.ntypes:
            raise ValueError(f"{name} needs {self.ntypes} element names, "
                             f"got {len(names)}")
        self.eam_type_elems = [None if e == "NULL" else e for e in names]
        d = read_setfl(self.eam_file, fs=name == "eam/fs")
        for t, elem in enumerate(self.eam_type_elems, start=1):
            if elem is None:
                continue
            if elem not in d["names"]:
                raise ValueError(f"element {elem} not found in "
                                 f"{self.eam_file}: has {d['names']}")
            if self.mass_type[t] == 0.0:
                self.mass_type[t] = d["mass"][d["names"].index(elem)]

    # ------------------------------ bonded -------------------------------

    @staticmethod
    def _coeff_vals(a):
        """Coefficient tokens: floats where possible, raw strings
        otherwise (table file and keyword, hybrid sub-style names)."""
        out = []
        for v in a:
            try:
                out.append(float(v))
            except ValueError:
                out.append(v)
        return out

    def _bonded_types(self, tok, fam):
        """force->bounds of a bonded type token: N, *, N*, *M, N*M."""
        try:
            return [int(tok)]
        except ValueError:
            pass
        arr = getattr(self, f"_{fam}_types", None)
        tmax = self.nbondtypes if fam == "bond" else 0
        if not tmax and arr is not None and len(arr):
            tmax = int(np.max(arr))
        lo, _, hi = tok.partition("*")
        return range(int(lo) if lo else 1, (int(hi) if hi else tmax) + 1)

    def _bonded_style(self, fam, styles, a):
        if a[0] not in styles:
            _unported(f"{fam}_style {a[0]}", _BREADTH)
        self._invalidate()
        setattr(self, f"{fam}_style", a[0])
        # table: interpolation and N; hybrid: the sub-styles
        setattr(self, f"{fam}_style_args", list(a[1:]))
        setattr(self, f"{fam}_coeffs", {})

    def _bonded_coeff(self, fam, a):
        self._invalidate()
        vals = self._coeff_vals(a[1:])
        store = getattr(self, f"{fam}_coeffs")
        for t in self._bonded_types(a[0], fam):
            store[t] = vals

    def cmd_bond_style(self, a):
        self._bonded_style("bond", BOND_STYLES, a)

    def cmd_bond_coeff(self, a):
        self._bonded_coeff("bond", a)

    def cmd_angle_style(self, a):
        self._bonded_style("angle", ANGLE_STYLES, a)

    def cmd_angle_coeff(self, a):
        self._bonded_coeff("angle", a)

    def cmd_dihedral_style(self, a):
        self._bonded_style("dihedral", DIHEDRAL_STYLES, a)

    def cmd_dihedral_coeff(self, a):
        self._bonded_coeff("dihedral", a)

    def cmd_improper_style(self, a):
        self._bonded_style("improper", IMPROPER_STYLES, a)

    def cmd_improper_coeff(self, a):
        self._bonded_coeff("improper", a)

    def cmd_pair_modify(self, a):
        i = 0
        while i < len(a):
            if a[i] == "mix":
                if a[i + 1] not in ("geometric", "arithmetic"):
                    _unported(f"pair_modify mix {a[i + 1]}", _BREADTH)
                self._pair_mix = a[i + 1]
            elif a[i] in ("table", "table/disp"):
                # erfc is evaluated by its polynomial and the dispersion
                # complement in closed form (no tables)
                pass
            elif a[i] == "shift":
                # the LJ energy less its value at the cutoff (the pair
                # tables' offset)
                self._pair_shift = _yesno(a[i + 1])
            elif a[i] == "tail":
                # the lj/cut family's long-range corrections (sim.py
                # tail_corrections), over the volume at each row
                self._pair_tail = _yesno(a[i + 1])
            else:
                _unported(f"pair_modify {a[i]}", _BREADTH)
            i += 2

    def cmd_kspace_style(self, a):
        """kspace_style ewald | ewald/disp | pppm | pppm/cg | pppm/stagger
        | pppm/tip4p | pppm/disp | pppm/disp/tip4p | msm | msm/cg
        ACCURACY; pppm/cg's and msm/cg's restriction to the charged atoms
        is a sparsity optimisation with the same result, so they run as
        pppm and msm (the JAX package's aliases)."""
        if a[0] == "none":
            self.kspace = None
        elif a[0] in KSPACE_STYLES:
            self.kspace = (a[0], float(a[1]))
        else:
            _unported(f"kspace_style {a[0]}", _BREADTH)

    def cmd_kspace_modify(self, a):
        """kspace_modify gewald G | gewald/disp G6 (pppm/disp's g_ewald_6,
        kspace.cpp modify_params) | cutoff/adjust yes|no (MSM's cutoff
        adjustment, kspace.cpp:534).  The JAX package ignores every other
        keyword (mesh, order, ...; ROADMAP queue 3 item 10); the port
        raises on them."""
        i = 0
        while i < len(a):
            if a[i] == "gewald":
                self._gewald_override = float(a[i + 1])
            elif a[i] == "gewald/disp":
                self._gewald6_override = float(a[i + 1])
            elif a[i] == "cutoff/adjust":
                self._msm_cutoff_adjust = a[i + 1] == "yes"
            else:
                _unported(f"kspace_modify {a[i]} (the JAX package ignores "
                          "it: ROADMAP queue 3 item 10)", _BREADTH)
            i += 2

    def cmd_special_bonds(self, a):
        if a[0] == "lj/coul":
            vals = [float(v) for v in a[1:4]]
            self.special_lj[1:] = vals
            self.special_coul[1:] = vals
        elif a[0] == "lj":
            self.special_lj[1:] = [float(v) for v in a[1:4]]
        elif a[0] == "coul":
            self.special_coul[1:] = [float(v) for v in a[1:4]]
        elif a[0] == "fene":
            # special_bonds fene = lj/coul 0 1 1 (special_bonds doc)
            self.special_lj[1:] = [0.0, 1.0, 1.0]
            self.special_coul[1:] = [0.0, 1.0, 1.0]
        elif a[0] == "amber":
            self.special_lj[1:] = [0.0, 0.0, 0.5]
            self.special_coul[1:] = [0.0, 0.0, 1.0 / 1.2]
        elif a[0] == "charmm":
            # the charmm dihedral's weighted 1-4 term replaces the pair 1-4
            self.special_lj[1:] = [0.0, 0.0, 0.0]
            self.special_coul[1:] = [0.0, 0.0, 0.0]
        else:
            _unported(f"special_bonds {a[0]}", _BREADTH)

    def cmd_group(self, a):
        name = a[0]
        n = self.x.shape[0]
        ops = (">", "<", ">=", "<=", "==", "!=")
        if a[1] == "molecule":
            m, val = self.mol.astype(float), float(a[3])
            sel = {">": m > val, "<": m < val, ">=": m >= val,
                   "<=": m <= val, "==": m == val, "!=": m != val}[a[2]]
        elif a[1] == "type":
            if a[2] in ops:
                t, val = self.type.astype(int), int(a[3])
                sel = {">": t > val, "<": t < val, ">=": t >= val,
                       "<=": t <= val, "==": t == val, "!=": t != val}[a[2]]
            else:
                sel = np.isin(self.type, [int(v) for v in a[2:]])
        elif a[1] == "id":
            sel = np.isin(np.arange(1, n + 1), [int(v) for v in a[2:]])
        elif a[1] == "region":
            sel = self._region_mask(a[2])
        elif a[1] == "union":
            sel = np.zeros(n, bool)
            for gname in a[2:]:
                sel |= self.groups[gname]
        elif a[1] == "subtract":
            sel = self.groups[a[2]].copy()
            for gname in a[3:]:
                sel &= ~self.groups[gname]
        else:
            _unported(f"group style {a[1]}", _FRONT_END)
        self.groups[name] = sel

    def cmd_thermo_style(self, a):
        if a[0] == "multi":
            cols = ["step", "etotal", "ke", "temp", "pe", "ebond", "eangle",
                    "edihed", "eimp", "evdwl", "ecoul", "elong", "press"]
        elif a[0] == "one":
            cols = ["step", "temp", "epair", "emol", "etotal", "press"]
        elif a[0] == "custom":
            cols = a[1:]
        else:
            _unported(f"thermo_style {a[0]}")
        for c in cols:
            if c.startswith("c_"):
                if c[2:].split("[")[0] not in self.computes:
                    raise ValueError(f"thermo_style: compute {c[2:]} does "
                                     "not exist")
            elif c.startswith("f_"):
                # JAX's thermo row holds fix cmap's energy and no output
                # fix's value: it prints nan for those
                if not self._is_cmap_fix(c[2:]):
                    _unported(f"thermo keyword {c} (a fix's global value)",
                              _NO_VALUE)
            elif not c.startswith("v_") and c not in THERMO_KEYWORDS:
                _unported(f"thermo keyword {c}")
        self.thermo_columns = cols

    def _is_cmap_fix(self, fid: str) -> bool:
        """Whether fix `fid` is a fix cmap (its f_ID: the crossterm
        energy)."""
        return fid in self.fixes and self.fixes[fid].style == "cmap"

    def cmd_thermo(self, a):
        self.thermo_every = int(a[0])

    def cmd_thermo_modify(self, a):
        i = 0
        while i < len(a):
            if a[i] == "norm":
                self._thermo_norm = _yesno(a[i + 1])
                i += 2
            elif a[i] == "temp":
                # thermo_modify temp ID (thermo.cpp modify_params): the
                # thermo temperature, KE and the pressure's kinetic part
                # follow this compute's group and dof (sim.py)
                if a[i + 1] not in self.computes:
                    raise ValueError("Could not find thermo_modify "
                                     f"temperature ID {a[i + 1]}")
                self._thermo_temp = a[i + 1]
                self._invalidate()
                i += 2
            elif a[i] == "format" and a[i + 1] in ("float", "none"):
                # thermo_modify format float FMT (thermo.cpp:586)
                self._thermo_float_format = (a[i + 2] if a[i + 1] == "float"
                                             else None)
                i += 3 if a[i + 1] == "float" else 2
            else:
                _unported(f"thermo_modify {' '.join(a[i:i + 2])}")

    def cmd_dump(self, a):
        """dump ID group style N file args (the JAX package's cmd_dump):
        atom (id type xs ys zs), custom (its columns), xyz (type x y z),
        dcd, cfg (`mass type xs ys zs` then vx vy vz q id), local (index,
        c_ID and c_ID[i] of the local computes), image and movie (the
        color and diameter attributes `type type`, then size, zoom, adiam
        and view)."""
        from lidp_tpu_torch.io import dump as dump_mod

        did, group, style, every = a[0], a[1], a[2], int(a[3])
        cols = list(a[5:])
        if style == "atom":
            # dump_atom.cpp default columns: id type xs ys zs
            cols = ["id", "type", "xs", "ys", "zs"]
        elif style == "custom":
            for c in cols:
                if c.startswith("v_"):
                    # an atom-style variable's column (JAX's writer has no
                    # such column either)
                    _unported(f"dump custom column {c} (atom-style "
                              "variables)", _BREADTH)
                if c not in dump_mod.COLUMNS and not c.startswith(
                        ("c_", "f_")):
                    _unported(f"dump custom column {c}")
        elif style == "xyz":
            cols = ["type", "x", "y", "z"]
        elif style == "dcd":
            cols = []
        elif style == "cfg":
            if cols[:5] != ["mass", "type", "xs", "ys", "zs"]:
                raise ValueError(
                    "dump cfg requires 'mass type xs ys zs' leading columns")
            for c in cols[5:]:
                if c not in ("vx", "vy", "vz", "q", "id"):
                    _unported(f"dump cfg auxiliary column {c} (the JAX "
                              "writer takes vx vy vz q id)")
        elif style == "local":
            self._check_local_columns(cols)
        elif style in ("image", "movie"):
            if cols[:2] != ["type", "type"]:
                _unported(f"dump {style} attributes {' '.join(cols[:2])} "
                          "(the JAX rasterizer colors and sizes by type "
                          "whatever they say)", _OUTPUT_FIXES)
            i = 2
            while i < len(cols):
                if cols[i] not in dump_mod.IMAGE_KEYWORDS:
                    _unported(f"dump {style} keyword {cols[i]} (the JAX "
                              "rasterizer reads size, zoom, adiam and view)",
                              _OUTPUT_FIXES)
                i += 1 + dump_mod.IMAGE_KEYWORDS[cols[i]]
        else:
            raise ValueError(f"unsupported dump style {style}")
        self.dumps[did] = DumpSpec(did=did, group=group, style=style,
                                   every=every,
                                   path=os.path.join(self.root, a[4]),
                                   columns=cols)

    def _check_local_columns(self, cols):
        """dump local's columns: index, or c_ID / c_ID[i] of a local
        compute with at least i values."""
        from lidp_tpu_torch.io.dump import LOCAL_STYLES

        for tok in cols:
            if tok == "index":
                continue
            if not tok.startswith("c_"):
                _unported(f"dump local column {tok} (index and c_ID only)")
            cid = tok[2:].split("[")[0]
            spec = self.computes.get(cid)
            if spec is None or spec[1] not in LOCAL_STYLES:
                raise ValueError(f"dump local column {tok}: not a local "
                                 "compute")
            nvals = len(spec[2]["values"] if spec[1] == "rigid/local"
                        else spec[2])
            k = int(tok[2:].rstrip("]").split("[")[1]) if "[" in tok else 1
            if not 1 <= k <= nvals:
                raise ValueError(f"dump local column {tok}: compute {cid} "
                                 f"has {nvals} values")

    def cmd_dump_modify(self, a):
        spec = self.dumps[a[0]]
        i = 1
        while i < len(a):
            if a[i] == "sort" and a[i + 1] == "id":
                i += 2   # the arrays are id-ordered
            elif a[i] == "format" and a[i + 1] == "float" \
                    and spec.style in ("custom", "atom"):
                spec.float_fmt = a[i + 2]
                i += 3
            else:
                _unported(f"dump_modify {' '.join(a[i:i + 2])}")

    def cmd_undump(self, a):
        self.dumps.pop(a[0], None)

    def cmd_velocity(self, a):
        # adopt any evolved state FIRST: velocity edits compose with the
        # positions/velocities of the last run
        self._invalidate()
        group = a[0]
        gm = self.groups[group]
        if a[1] == "set":
            # velocity group set vx vy vz (velocity.cpp::set; NULL keeps).
            # Lattice units (the default) scale each component by its
            # lattice spacing, 1 without a lattice command
            units = "lattice"
            i = 5
            while i < len(a):
                if a[i] != "units" or a[i + 1] not in ("box", "lattice"):
                    _unported(f"velocity set keyword {a[i]} {a[i + 1]}")
                units = a[i + 1]
                i += 2
            s3 = np.ones(3) if units == "box" else self._spacing3()
            for d, tok in enumerate(a[2:5]):
                if tok != "NULL":
                    self.v[gm, d] = float(tok) * s3[d]
            return
        if a[1] == "zero":
            # velocity group zero linear|angular (velocity.cpp::
            # zero_momentum, zero_rotation)
            if a[2] not in ("linear", "angular") or len(a) > 3:
                _unported(f"velocity zero {' '.join(a[2:])}", _BREADTH)
            m = self.mass_type[self.type][gm]
            if a[2] == "linear":
                self.v[gm] -= (m[:, None] * self.v[gm]).sum(0) / m.sum()
            else:
                self._zero_rotation(gm, m)
            return
        if a[1] == "scale":
            # velocity group scale T (velocity.cpp::scale): the group's
            # temperature on 3N - 3 dof, as the JAX package counts them
            if len(a) > 3:
                _unported(f"velocity scale keywords {' '.join(a[3:])} "
                          "(the JAX package skips them unread: ROADMAP "
                          "queue 3 item 11)")
            m = self.mass_type[self.type][gm]
            ke2 = float((m[:, None] * self.v[gm] ** 2).sum()) \
                * self.units.mvv2e
            t_cur = ke2 / ((3 * int(gm.sum()) - 3) * self.units.boltz)
            self.v[gm] *= np.sqrt(float(a[2]) / t_cur)
            return
        if a[1] == "ramp":
            self._velocity_ramp(gm, a)
            return
        if a[1] != "create":
            _unported(f"velocity {a[1]}", _FRONT_END)
        t_desired, seed = float(a[2]), int(a[3])
        # velocity.cpp options() defaults: dist uniform, loop all, mom yes,
        # rot no
        kw = dict(dist="uniform", loop="all", momentum=True, rotation=False)
        temp_group = None
        i = 4
        while i < len(a):
            k, v = a[i], a[i + 1]
            if k in ("dist", "loop"):
                kw[k] = v
            elif k == "mom":
                kw["momentum"] = _yesno(v)
            elif k == "rot":
                kw["rotation"] = _yesno(v)
            elif k == "temp":
                # rescaled by this temp compute's group and its dof,
                # dim*N - dim (velocity.cpp; the JAX package's :2110)
                if v not in self.computes:
                    raise ValueError(f"Could not find velocity temperature "
                                     f"ID {v}")
                temp_group = self.groups[self.computes[v][0]]
            elif k != "units":
                _unported(f"velocity create keyword {k}", _BREADTH)
            i += 2
        self.v = velocity_mod.create(
            self.x, self.mass_type[self.type], t_desired, seed,
            units=self.units, image=self.image,
            box_lengths=self.box_hi - self.box_lo, dim=self.dimension,
            group=None if group == "all" else gm, v_prev=self.v,
            temp_group=temp_group, **kw)

    def _zero_rotation(self, gm, m):
        """velocity.cpp zero_rotation: the group's angular velocity about
        its centre of mass (unwrapped positions, inertia tensor solve)
        taken out of v."""
        xu = (self.x + self.image * (self.box_hi - self.box_lo))[gm]
        xcm = (m[:, None] * xu).sum(0) / m.sum()
        d = xu - xcm
        ang = (m[:, None] * np.cross(d, self.v[gm])).sum(0)
        inertia = np.zeros((3, 3))
        inertia[0, 0] = np.sum(m * (d[:, 1] ** 2 + d[:, 2] ** 2))
        inertia[1, 1] = np.sum(m * (d[:, 0] ** 2 + d[:, 2] ** 2))
        inertia[2, 2] = np.sum(m * (d[:, 0] ** 2 + d[:, 1] ** 2))
        inertia[0, 1] = inertia[1, 0] = -np.sum(m * d[:, 0] * d[:, 1])
        inertia[0, 2] = inertia[2, 0] = -np.sum(m * d[:, 0] * d[:, 2])
        inertia[1, 2] = inertia[2, 1] = -np.sum(m * d[:, 1] * d[:, 2])
        omega = np.linalg.solve(inertia, ang)
        self.v[gm] -= np.cross(omega, d)

    def _velocity_ramp(self, gm, a):
        """velocity group ramp vdim vlo vhi cdim clo chi [sum yes|no]
        [units lattice|box] (velocity.cpp:631): in lattice units, the
        default, the velocities scale by the spacing along vdim and the
        coordinates by the spacing along cdim."""
        s3 = self._spacing3()
        v_dim = ("vx", "vy", "vz").index(a[2])
        c_dim = "xyz".index(a[5])
        sum_flag = False
        units_box = False
        i = 8
        while i < len(a):
            if a[i] == "sum":
                sum_flag = _yesno(a[i + 1])
            elif a[i] == "units" and a[i + 1] in ("box", "lattice"):
                units_box = a[i + 1] == "box"
            else:
                _unported(f"velocity ramp keyword {a[i]}", _FRONT_END)
            i += 2
        vs = 1.0 if units_box else s3[v_dim]
        cs = 1.0 if units_box else s3[c_dim]
        self.v = velocity_mod.ramp(
            self.x, self.v, gm, v_dim, float(a[3]) * vs, float(a[4]) * vs,
            c_dim, float(a[6]) * cs, float(a[7]) * cs, sum_flag)

    def cmd_fix(self, a):
        fid, group, style = a[0], a[1], a[2]
        if style not in FIX_STYLES + OUTPUT_STYLES:
            _unported(f"fix style {style}",
                      _FIX_ITEMS.get(style, _MODIFIERS))
        spec = FixSpec(fid=fid, group=group, style=style, args=a[3:])
        if style in OUTPUT_STYLES:
            fix_output.check_spec(self, spec)
        self.fixes[fid] = spec
        self._invalidate()

    def _unwrapped_x(self):
        """The host positions unwrapped by their image flags: where msd
        and displace/atom take their reference, at the compute's
        definition (compute_msd.cpp; the JAX package's cmd_compute)."""
        return (self.x + self.image * (self.box_hi - self.box_lo)).copy()

    def cmd_compute(self, a):
        """compute ID group style args (the JAX package's cmd_compute): the
        temperatures (temp, temp/partial, temp/com, temp/ramp,
        temp/region, temp/profile), pe, ke, com, gyration, msd and vacf
        (their reference taken now), rdf, group/group, pressure, reduce
        and reduce/region, slice, ke/rigid and erotate/rigid, the
        per-atom styles of computes.py, and the sphere computes of the
        granular route (erotate/sphere, temp/sphere, erotate/sphere/atom,
        contact/atom).  Stored as (group, style[, spec])
        and built into the Simulation; like the JAX package's, a compute
        defined after a run joins the run only once something rebuilds
        the Simulation."""
        cid, group, style = a[0], a[1], a[2]
        if style not in COMPUTE_STYLES:
            raise ValueError(f"unsupported compute style {style}")
        if group not in self.groups:
            raise ValueError(f"compute {cid}: group {group} does not exist")
        args = list(a[3:])
        if style == "temp":
            self.computes[cid] = (group, style)
            return
        if style == "temp/partial":
            spec = tuple(int(v) for v in args[:3])
        elif style == "temp/com":
            spec = ()
        elif style in ("pe", "ke", "com", "gyration"):
            if args:
                _unported(f"compute {style} arguments {' '.join(args)}",
                          _BREADTH)
            spec = None
        elif style == "msd":
            if args:
                _unported(f"compute msd keywords {' '.join(args)} (the JAX "
                          "package reads none)", _OUTPUT_FIXES)
            spec = self._unwrapped_x()
        elif style == "vacf":
            spec = self.v.copy()
        elif style == "rdf":
            if len(args) != 1:
                _unported(f"compute rdf {' '.join(args)} (Nbin alone: the "
                          "JAX package reads no type pairs)", _OUTPUT_FIXES)
            spec = int(args[0])
        elif style == "group/group":
            if len(args) != 1:
                _unported(f"compute group/group keywords {' '.join(args[1:])}"
                          " (the JAX package reads none)", _OUTPUT_FIXES)
            if args[0] not in self.groups:
                raise ValueError(f"compute {cid}: group {args[0]} does not "
                                 "exist")
            spec = args[0]
        elif style == "pressure":
            # thermo_temp: the thermo's own temperature (LAMMPS's default
            # compute; the JAX package falls back to the thermo's)
            spec = {"temp": args[0] if args else "NULL", "kw": args[1:]}
            if spec["temp"] not in ("NULL", "thermo_temp") \
                    and spec["temp"] not in self.computes:
                raise ValueError(f"compute {cid}: temperature compute "
                                 f"{spec['temp']} does not exist")
            if any(k != "virial" for k in spec["kw"]):
                _unported(f"compute pressure keywords {' '.join(spec['kw'])}"
                          " (the JAX package reads `virial` alone)",
                          _OUTPUT_FIXES)
        elif style in ("reduce", "reduce/region"):
            region = None
            if style == "reduce/region":
                region, args = args[0], args[1:]
                if region not in self.regions:
                    raise ValueError(f"compute {cid}: region {region} does "
                                     "not exist")
            if args[0] not in ("sum", "min", "max", "ave"):
                _unported(f"compute reduce mode {args[0]}", _BREADTH)
            for t in args[1:]:
                if t.startswith("v_"):
                    _unported(f"compute reduce input {t} (atom-style "
                              "variables)", _BREADTH)
            style = "reduce"
            spec = {"mode": args[0], "inputs": args[1:], "region": region}
        elif style == "slice":
            spec = {"start": int(args[0]), "stop": int(args[1]),
                    "skip": int(args[2]), "inputs": list(args[3:])}
            for t in spec["inputs"]:
                name = t[2:].split("[")[0] if t.startswith("c_") else None
                if name not in self.computes:
                    raise ValueError(f"compute slice input {t}: no such "
                                     "compute")
                fix_output.check_global(self, t, "compute slice")
        elif style in ("temp/ramp", "temp/region", "temp/profile",
                       "temp/deform"):
            if style == "temp/deform" and args:
                _unported(f"compute temp/deform keywords {' '.join(args)} "
                          "(the JAX package reads none)", _OUTPUT_FIXES)
            spec = args
            if style == "temp/region" and args[0] not in self.regions:
                raise ValueError(f"compute {cid}: region {args[0]} does not "
                                 "exist")
        elif style in ("ke/rigid", "erotate/rigid"):
            spec = args[0]
        elif style == "stress/atom":
            # the bias temperature compute (compute_stress_atom.cpp:42)
            if args and args[0] != "NULL" or len(args) > 1:
                raise NotImplementedError(
                    "compute stress/atom supports temp-ID NULL only")
            spec = {}
        elif style in ("coord/atom", "cluster/atom"):
            # coord/atom cutoff X | cluster/atom X
            spec = {"cutoff": float(args[1] if args[0] == "cutoff"
                                    else args[0])}
        elif style == "displace/atom":
            spec = {"x0": self._unwrapped_x()}
        elif style in SPHERE_COMPUTES:
            # compute_erotate_sphere.cpp, compute_temp_sphere.cpp,
            # compute_erotate_sphere_atom.cpp, compute_contact_atom.cpp
            if args:
                _unported(f"compute {style} arguments {' '.join(args)} (the "
                          "JAX package reads none)", _OUTPUT_FIXES)
            spec = {}
        elif style == "property/atom":
            for w in args:
                if w not in ("x", "y", "z", "vx", "vy", "vz", "fx", "fy",
                             "fz", "q", "type", "mol", "mass", "id"):
                    raise KeyError(f"compute property/atom field {w}")
            spec = {"fields": args}
        elif style == "rigid/local":
            # compute ID group rigid/local fix-ID value... (compute_rigid_
            # local.cpp:61-96): one row per body of the run's rigid fix
            from lidp_tpu_torch.io.dump import RIGID_LOCAL_VALUES

            if len(args) < 2:
                raise ValueError(f"compute {cid}: rigid/local needs a fix ID "
                                 "and values")
            for v in args[1:]:
                if v not in RIGID_LOCAL_VALUES:
                    raise ValueError(f"rigid/local value {v}")
            spec = {"fix": args[0], "values": args[1:]}
        elif style.endswith("/local"):
            spec = self._local_spec(style, args)
        elif style in _STRUCTURE_STYLES or style == "heat/flux":
            spec = self._structure_spec(style, args)
        elif style == "chunk/atom":
            spec = self._chunk_atom_spec(args)
        elif style.endswith("/chunk"):
            spec = self._chunk_agg_spec(style, args)
        else:   # ke/atom, pe/atom
            spec = {}
        self.computes[cid] = (group, style, spec)

    def _local_spec(self, style, args):
        """The values of pair/local, bond/local, angle/local,
        dihedral/local, improper/local and property/local (io/dump.py's
        tables), evaluated at dump local's frames.  The pair columns keep
        the pairs neigh_modify exclude drops, in the JAX package too: the
        port refuses them there."""
        from lidp_tpu_torch.io import dump as dump_mod

        allowed = {
            "pair/local": dump_mod.PAIR_LOCAL_VALUES,
            "bond/local": ("dist", "engpot", "force"),
            "angle/local": ("theta", "eng"),
            "dihedral/local": ("phi",),
            "improper/local": ("chi",),
            "property/local": dump_mod.PROPERTY_PAIR_VALUES
            + dump_mod.PROPERTY_BOND_VALUES}[style]
        if not args:
            raise ValueError(f"compute {style} needs values")
        for v in args:
            if v not in allowed:
                # compute_pair_local.cpp and compute_property_local.cpp's
                # cutoff, the bonded styles' set
                if v in ("cutoff", "set"):
                    _unported(f"compute {style} keyword {v} (the JAX "
                              "package reads none)", _OUTPUT_FIXES)
                raise ValueError(f"{style} value {v}")
        pairs = style == "pair/local" or (
            style == "property/local" and args[0][0] in "pn")
        if pairs and (self.neigh_exclude_types or self.neigh_exclude_mol):
            _unported(f"compute {style} with neigh_modify exclude (the JAX "
                      "package keeps the excluded pairs)",
                      "ROADMAP queue 3 item 49")
        return list(args)

    def _structure_spec(self, style, args):
        """The arguments of centro/atom fcc|bcc|N, cna/atom cutoff,
        orientorder/atom [nnn N|NULL] [degrees nq l...] [components l]
        [cutoff c], hexorder/atom [degree n] [nnn N|NULL] [cutoff c],
        fragment/atom, aggregate/atom cutoff, global/atom index input...
        and heat/flux ke-ID pe-ID stress-ID (the JAX package's
        cmd_compute).  Where the JAX package reads the leading arguments
        and skips the rest, the port raises on the rest."""
        def extra(k):
            if len(args) > k:
                _unported(f"compute {style} arguments "
                          f"{' '.join(args[k:])} (the JAX package reads "
                          "none)", _OUTPUT_FIXES)

        if style in ("centro/atom", "cna/atom"):
            extra(1)
            if style == "cna/atom":
                float(args[0])
            elif args[0] not in ("fcc", "bcc"):
                int(args[0])
            return {"arg": args[0]}
        if style in ("orientorder/atom", "hexorder/atom"):
            d = {}
            i = 0
            while i < len(args):
                if args[i] == "nnn":
                    d["nnn"] = 0 if args[i + 1] == "NULL" \
                        else int(args[i + 1])
                    i += 2
                elif args[i] == "degrees" and style == "orientorder/atom":
                    nq = int(args[i + 1])
                    d["degrees"] = [int(v) for v in args[i + 2:i + 2 + nq]]
                    i += 2 + nq
                elif args[i] == "degree" and style == "hexorder/atom":
                    d["degree"] = int(args[i + 1])
                    i += 2
                elif args[i] == "components" \
                        and style == "orientorder/atom":
                    d["components"] = int(args[i + 1])
                    i += 2
                elif args[i] == "cutoff":
                    d["cutoff"] = float(args[i + 1])
                    i += 2
                else:
                    raise ValueError(f"{style} keyword {args[i]}")
            return {"arg": d}
        if style == "fragment/atom":
            extra(0)
            return {}
        if style == "aggregate/atom":
            extra(1)
            return {"cutoff": float(args[0])}
        if style == "global/atom":
            ref = args[0]
            if ref.startswith("c_") and ref[2:].split("[")[0] \
                    not in self.computes:
                raise ValueError(f"compute global/atom index {ref}: no "
                                 "such compute")
            for t in args[1:]:
                fix_output.check_global(self, t, "compute global/atom")
            return {"ref": ref, "inputs": list(args[1:])}
        # heat/flux
        extra(3)
        for cid in args[:3]:
            if cid not in self.computes:
                raise ValueError(f"compute heat/flux: compute {cid} does "
                                 "not exist")
        return {"ids": list(args[:3])}

    def _chunk_atom_spec(self, args):
        """compute ID group chunk/atom bin/1d|2d|3d (dim origin delta)...
        [units box|lattice|reduced] | type | molecule (the JAX package's
        cmd_compute; compute_chunk_atom.cpp setup_xyz_bins): origin lower,
        center, upper or a coordinate; units lattice by default.  The JAX
        package skips every other keyword (discard, nchunk, limit, ids,
        compress, bound, region, pbc, ...): the port raises on them."""
        which = args[0]
        spec = {"which": which}
        if which in ("bin/1d", "bin/2d", "bin/3d"):
            nd = int(which[4])
            dims, origins, deltas = [], [], []
            i = 1
            for _ in range(nd):
                dims.append({"x": 0, "y": 1, "z": 2}[args[i]])
                origin = args[i + 1]
                if origin not in ("lower", "center", "upper"):
                    float(origin)
                origins.append(origin)
                deltas.append(float(args[i + 2]))
                i += 3
            spec.update(dims=dims, origins=origins, deltas=deltas,
                        dim=dims[0], origin=origins[0], delta=deltas[0],
                        units="lattice")
            while i < len(args):
                if args[i] == "units" and args[i + 1] in (
                        "box", "lattice", "reduced"):
                    spec["units"] = args[i + 1]
                else:
                    _unported(f"compute chunk/atom keyword {args[i]} (the "
                              "JAX package skips it)", _OUTPUT_FIXES)
                i += 2
        elif which in ("type", "molecule"):
            if len(args) > 1:
                _unported(f"compute chunk/atom keyword {args[1]} (the JAX "
                          "package skips it)", _OUTPUT_FIXES)
        else:
            raise ValueError(f"unsupported chunk/atom style {which}")
        return spec

    def _chunk_agg_spec(self, style, args):
        """compute ID group <style>/chunk chunkID [values/keywords]
        (compute_com_chunk.cpp and its siblings): gyration/chunk takes
        `tensor`, dipole/chunk `mass` or `geometry`, property/chunk its
        fields count, id, coord1..3, temp/chunk `com yes|no`, `adof`,
        `cdof` and the values temp, kecom, internal; the JAX package
        ignores any other word of the first two and of the others, and
        the port raises on it."""
        cid = args[0]
        if self.computes.get(cid, (None, None))[1] != "chunk/atom":
            raise ValueError(f"compute {style}: chunk/atom compute {cid} "
                             "does not exist")
        extra = list(args[1:])
        ok = {"gyration/chunk": ("tensor",),
              "dipole/chunk": ("mass", "geometry")}.get(style, ())
        if style == "property/chunk":
            for tok in extra:
                if tok not in ("count", "id", "coord1", "coord2", "coord3"):
                    raise ValueError(f"property/chunk field {tok}")
        elif style == "temp/chunk":
            for tok in computes_mod.temp_chunk_keywords(extra, 3)[3]:
                if tok not in ("temp", "kecom", "internal"):
                    raise ValueError(f"temp/chunk value {tok}")
        else:
            for tok in extra:
                if tok not in ok:
                    _unported(f"compute {style} argument {tok} (the JAX "
                              "package reads none)", _OUTPUT_FIXES)
        return {"chunk": cid, "extra": extra}

    def cmd_uncompute(self, a):
        self.computes.pop(a[0], None)
        self._invalidate()

    def cmd_compute_modify(self, a):
        """compute_modify ID extra N | dynamic yes|no (compute.cpp
        modify_params): extra replaces the dof a temperature compute
        subtracts (thermo_temp's the thermo temperature's).  dynamic, which
        the JAX package stores unread, changes nothing while no atom
        joins or leaves a group (the port has no such run)."""
        cmod = self._compute_modify.setdefault(a[0], {})
        i = 1
        while i < len(a):
            if a[i] == "extra":
                cmod["extra"] = a[i + 1]
            elif a[i] == "dynamic":
                _yesno(a[i + 1])
            else:
                _unported(f"compute_modify {a[i]} (the JAX package stores "
                          "it unread)", _OUTPUT_FIXES)
            i += 2
        self._invalidate()

    def cmd_fix_modify(self, a):
        """fix_modify ID temp COMPUTE-ID (fix.cpp modify_params) on fix
        temp/rescale or temp/berendsen: the fix's temperature takes the
        compute's group and dof (sim.py; the JAX package's sim.py
        :1839-1846); fix_modify ID energy yes|no on fix cmap: its
        crossterm energy in the potential energy or not (fix.cpp
        thermo_energy; the JAX package's sim.py:1494-1500).  The JAX
        package stores every other keyword, and these on every other fix
        style, and reads them nowhere: the port raises on them (ROADMAP
        queue 3 item 11)."""
        fid = a[0]
        if fid not in self.fixes:
            raise ValueError(f"Could not find fix_modify ID {fid}")
        style = self.fixes[fid].style
        kw = {}
        i = 1
        while i < len(a):
            if a[i] == "energy" and style == "cmap":
                _yesno(a[i + 1])
                kw["energy"] = a[i + 1]
                i += 2
                continue
            if a[i] != "temp" or style not in ("temp/rescale",
                                                "temp/berendsen"):
                _unported(f"fix_modify {a[i]} on fix {style} (the JAX "
                          "package stores it unread: ROADMAP queue 3 item "
                          "11)", _MODIFIERS)
            if a[i + 1] not in self.computes:
                raise ValueError("Could not find fix_modify temperature "
                                 f"ID {a[i + 1]}")
            kw["temp"] = a[i + 1]
            i += 2
        self._fix_modify.setdefault(fid, {}).update(kw)
        self._invalidate()

    def cmd_unfix(self, a):
        self.fixes.pop(a[0], None)
        self._invalidate()

    def cmd_pair_write(self, a):
        """pair_write ITYPE JTYPE N r|rsq INNER OUTER FILE [KEYWORD [QI
        QJ]] (Pair::write_file, pair.cpp:1549; the JAX package's
        cmd_pair_write): N rows `i r E F` of the pair style's single()
        (ops/pair.py pair_single on the first pair table, in float64 on
        the host), zero beyond the pair's cutoff, appended to FILE in the
        format pair_style table reads."""
        from lidp_tpu_torch.computes import pair64
        from lidp_tpu_torch.ops.pair import pair_single
        from lidp_tpu_torch.sim import Simulation

        itype, jtype, n = int(a[0]), int(a[1]), int(a[2])
        style = a[3]
        inner, outer = float(a[4]), float(a[5])
        if inner <= 0.0 or inner >= outer:
            raise ValueError("Invalid cutoffs in pair_write command")
        if style not in ("r", "rsq"):
            raise ValueError(f"Invalid style in pair_write command: {style}")
        path = os.path.join(self.root, a[6])
        keyword = a[7] if len(a) > 7 else "TABLE"
        qi = float(a[8]) if len(a) > 8 else 1.0
        qj = float(a[9]) if len(a) > 9 else 1.0
        if self._sim is None:
            self._sim = Simulation.from_script(self)
        pp = pair64(self._sim)
        if pp is None:
            raise ValueError("Pair style does not support pair_write")
        k = np.arange(n)
        if style == "r":
            r = inner + (outer - inner) * k / (n - 1)
            rsq = r * r
        else:
            rsq = inner**2 + (outer**2 - inner**2) * k / (n - 1)
            r = np.sqrt(rsq)
        e, ff = pair_single(torch.as_tensor(rsq), itype, jtype, qi, qj,
                            _to_host(pp))
        e, ff = e.numpy(), ff.numpy() * r
        incut = rsq < float(pp.cutsq[itype, jtype])
        e = np.where(incut, e, 0.0)
        ff = np.where(incut, ff, 0.0)
        with open(path, "a") as fh:
            fh.write(f"# Pair potential {self.pair.name} for atom types "
                     f"{itype} {jtype}: i,r,energy,force\n")
            fh.write(f"\n{keyword}\nN {n} {'R' if style == 'r' else 'RSQ'} "
                     f"{inner:.15g} {outer:.15g}\n\n")
            for m in range(n):
                fh.write(f"{m + 1} {r[m]:.15g} {e[m]:.15g} {ff[m]:.15g}\n")

    def cmd_write_data(self, a):
        """write_data file — the inverse of read_data (write_data.cpp)."""
        from lidp_tpu_torch.io.data_writer import write_data

        write_data(os.path.join(self.root, a[0]), self)

    def cmd_min_style(self, a):
        if a[0] not in MIN_STYLES:
            raise ValueError(f"unsupported min_style {a[0]}")
        self._min_style = a[0]

    def cmd_min_modify(self, a):
        """min_modify dmax D | line quadratic (min.cpp modify_params): dmax
        caps the steps of cg, sd, quickmin and hftn; the JAX package's line
        search is its secant emulation of linemin_quadratic, the default.
        The JAX package stores every other key unread; the port raises on
        them (ROADMAP queue 3 item 11)."""
        i = 0
        while i < len(a):
            if a[i] == "dmax":
                self._min_modify["dmax"] = float(a[i + 1])
            elif not (a[i] == "line" and a[i + 1] == "quadratic"):
                _unported(f"min_modify {' '.join(a[i:i + 2])} (the JAX "
                          "package stores it unread: ROADMAP queue 3 item "
                          "11)", _BREADTH)
            i += 2

    def cmd_minimize(self, a):
        """minimize etol ftol maxiter maxeval (Min::run; the JAX package's
        script.py:2527-2583) with the current min_style
        (integrate/minimize.py; cg by default) on the force field's pair
        and k-space energy (E_pair), evaluated on the dense route at every
        size, with no fix's post_force; then fix box/relax's outer loop.
        maxeval is read and unused, as in the JAX package.  v is zeroed,
        the next run sets up again, and the minimized x is adopted."""
        from lidp_tpu_torch.forcefield import compute_forces
        from lidp_tpu_torch.integrate import minimize as min_mod
        from lidp_tpu_torch.sim import Simulation

        etol, ftol, maxiter = float(a[0]), float(a[1]), int(a[2])
        if self._sim is None:
            self._sim = Simulation.from_script(self)
        sim = self._sim
        ff = sim.runner.ff
        if ff.polar_xshift is not None \
                and not isinstance(ff.polar_xshift, torch.Tensor):
            # the panel engine keeps it on the host
            ff = dataclasses.replace(ff, polar_xshift=torch.as_tensor(
                ff.polar_xshift, dtype=self.dtype, device=self.device))
        mass_atom = self.mass_type[self.type]

        def compute(sys_):
            res = compute_forces(sys_, ff)
            return res.f, res.epair

        style = self._min_style
        kw = dict(etol=etol, ftol=ftol, maxiter=maxiter)
        dmax = self._min_modify.get("dmax", 0.1)
        if style == "fire":
            run_min = lambda s_: min_mod.fire_minimize(  # noqa: E731
                s_, compute, mass_atom, **kw)
        elif style == "quickmin":
            run_min = lambda s_: min_mod.quickmin_minimize(  # noqa: E731
                s_, compute, mass_atom, dt=self.dt, dmax=dmax,
                ftm2v=self.units.ftm2v, **kw)
        elif style == "hftn":
            run_min = lambda s_: min_mod.hftn_minimize(  # noqa: E731
                s_, compute, dmax=dmax, **kw)
        else:
            run_min = lambda s_: min_mod.cg_minimize(  # noqa: E731
                s_, compute, dmax=dmax, style=style, **kw)
        sys2, e, it, conv = run_min(sim.sys)
        relax = next((f for f in self.fixes.values()
                      if f.style == "box/relax"), None)
        if relax is not None:
            sys2, e = self._box_relax(relax, sys2, run_min, ff)
        sim.sys = sys2.replace(v=torch.zeros_like(sys2.v))
        sim.res = None    # the next run sets up again
        self.x = sys2.x[:sim.natoms].cpu().numpy().copy()
        self.minimized.append((float(e), int(it), bool(conv)))
        self.log(f"# minimize: E = {float(e):.8g} after {int(it)} "
                 "iterations")

    def _box_relax(self, spec, sys2, run_min, ff):
        """fix box/relax iso|aniso|x|y|z P [vmax V] (the JAX package's
        _box_relax, script.py:2585-2666): a secant loop on P(strain), each
        step a vmax-capped affine strain of the box about its centre
        followed by a whole minimization, until P is within max(1e-8,
        1e-6 |P_target|) of the target (400 steps at most).  The pressure
        is the virial's diagonal over the box volume, in 2d too, as in the
        JAX package (ROADMAP queue 3); iso averages the first `dimension`
        components.  Returns (sys, energy)."""
        from lidp_tpu_torch.box import Box
        from lidp_tpu_torch.forcefield import compute_forces
        from lidp_tpu_torch.styles.fix_modifiers import box_relax_spec

        p_t, iso, vmax = box_relax_spec(spec.args)
        flags = np.array([v is not None for v in p_t])
        tgt = np.array([v if v is not None else 0.0 for v in p_t])
        nktv2p = self.units.nktv2p
        dim = self.dimension

        def press_dims(sys_):
            res = compute_forces(sys_, ff)
            v6 = res.virial.cpu().numpy()
            p = v6[:3] / float(sys_.box.volume) * nktv2p
            return (np.full(3, p[:dim].mean()) if iso else p), float(
                res.epair)

        prev = None
        e = None
        for _ in range(400):
            p_cur, e = press_dims(sys2)
            dp = np.where(flags, p_cur - tgt, 0.0)
            if np.abs(dp).max() < max(1e-8, 1e-6 * np.abs(tgt).max()):
                break
            if prev is None:
                # the probe: expand where P is above the target
                ds = np.clip(np.sign(dp) * 1e-4, -vmax, vmax)
            else:
                s_prev, p_prev = prev
                dPds = (p_cur - p_prev) / np.where(
                    np.abs(s_prev) > 0, s_prev, 1.0)
                dPds = np.where(np.abs(dPds) > 1e-30, dPds, -1e30)
                ds = np.clip(-dp / dPds, -vmax, vmax)
            ds = np.where(flags, ds, 0.0)
            if iso:
                ds[:] = ds[:dim].mean()
                if dim == 2:
                    ds[2] = 0.0
            lo = sys2.box.lo.cpu().numpy()
            hi = sys2.box.hi.cpu().numpy()
            c = 0.5 * (lo + hi)
            scale = 1.0 + ds
            box = Box.create(c + (lo - c) * scale, c + (hi - c) * scale,
                             dtype=sys2.x.dtype, periodic=sys2.box.periodic,
                             device=sys2.x.device)
            x = torch.as_tensor(c + (sys2.x.cpu().numpy() - c) * scale,
                                dtype=sys2.x.dtype, device=sys2.x.device)
            sys2, e, _, _ = run_min(sys2.replace(x=x, box=box))
            prev = (ds, p_cur)
        return sys2, e

    def cmd_displace_atoms(self, a):
        """displace_atoms group move dx dy dz | ramp ddim dlo dhi cdim clo
        chi | random dx dy dz seed [units box|lattice]
        (displace_atoms.cpp:111-199; lattice units by default), then each
        atom remapped into the box along the periodic dimensions with its
        image flags.  random draws each atom's three uniforms from a
        RanPark stream seeded by its coordinates (park_geom_streams), as
        the reference and the JAX package do."""
        self._invalidate()
        gm = np.asarray(self.groups[a[0]], bool)
        style = a[1]
        nargs = {"move": 5, "ramp": 8, "random": 6}
        if style not in nargs:
            _unported(f"displace_atoms {style}", _BREADTH)
        kw = a[nargs[style]:]
        if kw and (len(kw) != 2 or kw[0] != "units"
                   or kw[1] not in ("box", "lattice")):
            _unported(f"displace_atoms keywords {' '.join(kw)}", _BREADTH)
        scale = (np.ones(3) if kw and kw[1] == "box"
                 else self._spacing3())
        x = np.asarray(self.x, float).copy()
        if style == "move":
            d = scale * np.array([float(a[2]), float(a[3]), float(a[4])])
            x[gm] += d
        elif style == "ramp":
            ddim = "xyz".index(a[2])
            dlo, dhi = scale[ddim] * float(a[3]), scale[ddim] * float(a[4])
            cdim = "xyz".index(a[5])
            clo, chi = scale[cdim] * float(a[6]), scale[cdim] * float(a[7])
            frac = np.clip((x[:, cdim] - clo) / (chi - clo), 0.0, 1.0)
            x[gm, ddim] += (dlo + frac * (dhi - dlo))[gm]
        else:
            from lidp_tpu_torch.rng import park_geom_streams

            d = scale * np.array([float(a[2]), float(a[3]), float(a[4])])
            streams = park_geom_streams(int(a[5]), x)
            disp = np.stack([d[k] * 2.0 * (streams.uniform() - 0.5)
                             for k in range(3)], axis=1)
            x[gm] += disp[gm]
        # Domain::remap on the periodic dimensions
        L = self.box_hi - self.box_lo
        for dim in range(3):
            if self.periodic[dim]:
                shift = np.floor((x[:, dim] - self.box_lo[dim]) / L[dim])
                x[:, dim] -= shift * L[dim]
                self.image[:, dim] += shift.astype(self.image.dtype)
        self.x = x

    def cmd_delete_atoms(self, a):
        """delete_atoms region ID | group ID | overlap cut group1 group2 |
        porosity region-ID frac seed (delete_atoms.cpp; the JAX package's
        script.py:2191-2294): every per-atom host array and the groups
        compacted, the survivors keeping their order.  With bonds (or any
        topology) present it raises, as the JAX package does."""
        self._invalidate()
        nargs = {"region": 2, "group": 2, "overlap": 4, "porosity": 4}
        if a[0] not in nargs:
            _unported(f"delete_atoms {a[0]}", _FRONT_END)
        if len(a) > nargs[a[0]]:
            _unported(f"delete_atoms keywords {' '.join(a[nargs[a[0]]:])}",
                      _FRONT_END)
        if a[0] == "region":
            kill = self._region_mask(a[1])
        elif a[0] == "group":
            kill = self.groups[a[1]].copy()
        elif a[0] == "overlap":
            kill = self._delete_overlap(float(a[1]), a[2], a[3])
        else:
            kill = self._delete_porosity(a[1], float(a[2]), int(a[3]))
        if any(t is not None and len(t) for t in (
                self._bonds, self._angles, self._dihedrals, self._impropers,
                self._crossterms)):
            raise NotImplementedError("delete_atoms with bonds present")
        keep = ~kill
        for attr in ("x", "v", "q", "type", "mol", "image"):
            setattr(self, attr, np.asarray(getattr(self, attr))[keep])
        self.groups = {k: np.asarray(v)[keep]
                       for k, v in self.groups.items()}
        self.log(f"Deleted {int(kill.sum())} atoms, "
                 f"new total = {self.x.shape[0]}")

    def _delete_overlap(self, cut, g1, g2):
        """delete_atoms overlap (DeleteAtoms::delete_overlap, serial): in
        index order, atom i of group1 is deleted when an atom j of group2
        lies within cut and j is not deleted yet.  A pair found across a
        periodic face has j a ghost (delete_atoms.cpp:404-407): if i is in
        group2 and j in group1, only the lower index dies; otherwise i
        dies whatever j's state.  No topology, so no special pair to
        skip; the JAX package's sweep."""
        x = np.asarray(self.x, np.float64)
        n = x.shape[0]
        if self._bonds is not None and len(self._bonds):
            raise NotImplementedError("delete_atoms overlap with bonds")
        in1 = np.asarray(self.groups[g1], bool)
        in2 = np.asarray(self.groups[g2], bool)
        L = (self.box_hi - self.box_lo).astype(np.float64)
        per = np.asarray(self.periodic, bool)
        cutsq = cut * cut
        neigh = [[] for _ in range(n)]
        chunk = max(1, min(n, 4_000_000 // max(n, 1) + 1))
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            d = x[s:e, None, :] - x[None, :, :]
            crossed = np.zeros(d.shape[:2], bool)
            for k in range(3):
                if per[k]:
                    shift = np.round(d[:, :, k] / L[k])
                    d[:, :, k] -= L[k] * shift
                    crossed |= shift != 0
            rsq = (d * d).sum(-1)
            ii, jj = np.nonzero((rsq < cutsq) & in1[s:e, None]
                                & in2[None, :])
            ghost = crossed[ii, jj]
            ii += s
            own = ii != jj
            for i, j, g in zip(ii[own], jj[own], ghost[own]):
                neigh[i].append((j, bool(g)))
        dlist = np.zeros(n, bool)
        for i in range(n):
            for j, ghost in neigh[i]:
                if not ghost:
                    if dlist[j]:
                        continue
                elif in2[i] and in1[j] and i > j:
                    continue
                dlist[i] = True
                break
        return dlist

    def _delete_porosity(self, region, frac, seed):
        """delete_atoms porosity (delete_atoms.cpp:420): one RanMars(seed)
        uniform per atom of the region, in atom order; deleted when it is
        <= frac."""
        from lidp_tpu_torch.rng import RanMars

        rng = RanMars(seed)
        inside = np.asarray(self._region_mask(region), bool)
        dlist = np.zeros(inside.shape[0], bool)
        for i in np.nonzero(inside)[0]:
            if rng.uniform() <= frac:
                dlist[i] = True
        return dlist

    # read_dump's keywords and the values the JAX package's behaviour
    # matches (read_dump.cpp defaults; it reads none of them)
    _READ_DUMP_DEFAULTS = {"box": "yes", "replace": "yes", "purge": "no",
                           "add": "no", "trim": "no", "format": "native",
                           "wrapped": "yes", "scaled": "no", "label": None}

    def _read_dump_fields(self, toks):
        """read_dump's field list, then its keywords: those at the values
        the JAX package's behaviour matches are taken, the others raise."""
        fields = []
        i = 0
        while i < len(toks) and toks[i] not in self._READ_DUMP_DEFAULTS:
            if toks[i] not in ("x", "y", "z", "xs", "ys", "zs", "vx", "vy",
                               "vz", "q", "ix", "iy", "iz"):
                _unported(f"read_dump field {toks[i]} (x y z xs ys zs vx vy "
                          "vz q ix iy iz)")
            fields.append(toks[i])
            i += 1
        while i < len(toks):
            kw = toks[i]
            val = toks[i + 1] if i + 1 < len(toks) else None
            if kw not in self._READ_DUMP_DEFAULTS \
                    or val != self._READ_DUMP_DEFAULTS[kw]:
                _unported(f"read_dump keyword {kw} {val} (the JAX package "
                          "reads none)", _OUTPUT_FIXES)
            i += 2
        if not fields:
            raise ValueError("read_dump needs fields")
        return fields

    def _apply_dump_frame(self, frame, fields):
        """Overwrite the per-atom state from one dump frame's columns
        (read_dump.cpp atoms; the JAX package's _apply_dump_frame): the
        live Simulation dropped first (its state adopted), atoms matched by
        the id column when present, else file order; the box from the
        frame's bounds and the step from its TIMESTEP."""
        step, lo, hi, cols, data = frame
        self._invalidate()
        if len(data) != len(self.x):
            _unported(f"read_dump of a frame of {len(data)} atoms into "
                      f"{len(self.x)} (purge, add and trim)")
        self.box_lo, self.box_hi = lo, hi
        order = (np.argsort(data[:, cols.index("id")], kind="stable")
                 if "id" in cols else np.arange(len(data)))
        data = data[order]
        x = np.asarray(self.x, float).copy()
        v = np.asarray(self.v, float).copy()
        L = hi - lo
        for f_ in fields:
            if f_ not in cols:
                raise ValueError(f"read_dump field {f_} not in dump file")
            col = data[:, cols.index(f_)]
            if f_ in ("x", "y", "z"):
                x[:, "xyz".index(f_)] = col
            elif f_ in ("xs", "ys", "zs"):
                d = "xyz".index(f_[0])
                x[:, d] = lo[d] + col * L[d]
            elif f_ in ("vx", "vy", "vz"):
                v[:, "xyz".index(f_[1])] = col
            elif f_ == "q":
                self.q = col.copy()
            else:
                self.image[:, "xyz".index(f_[1])] = col.astype(
                    self.image.dtype)
        self.x, self.v = x, v
        self.step = step

    def cmd_read_dump(self, a):
        """read_dump file Nstep field... [keyword value ...]
        (read_dump.cpp): the frame of step Nstep into the system."""
        from lidp_tpu_torch.io.dump import read_dump_frames

        want = int(a[1])
        fields = self._read_dump_fields(a[2:])
        for fr in read_dump_frames(os.path.join(self.root, a[0])):
            if fr[0] == want:
                self._apply_dump_frame(fr, fields)
                return
        raise ValueError(f"read_dump: timestep {want} not in {a[0]}")

    def cmd_rerun(self, a):
        """rerun file... [first N] [last M] [every E] [skip S] dump
        field... [keyword value ...] (rerun.cpp): each selected frame read
        as read_dump reads it, then `run 0`: the Simulation is rebuilt and
        evaluated on it, its thermo row and dump frames written.  Each
        frame's (rebuild ms, evaluation ms) is appended to
        self.rerun_timings."""
        from lidp_tpu_torch.io.dump import read_dump_frames
        from lidp_tpu_torch.sim import Simulation

        kws = ("first", "last", "every", "skip", "start", "stop", "dump")
        ikw = next((k for k, tok in enumerate(a) if tok in kws), len(a))
        files = a[:ikw]
        first, last, every, skip = 0, 2**62, 0, 1
        i = ikw
        fields = None
        while i < len(a):
            if a[i] == "dump":
                fields = self._read_dump_fields(a[i + 1:])
                break
            if a[i] in ("start", "stop"):
                _unported(f"rerun keyword {a[i]} (the JAX package reads "
                          "it nowhere)", _OUTPUT_FIXES)
            if a[i] not in kws:
                raise ValueError(f"Illegal rerun command: {a[i]}")
            val = int(a[i + 1])
            if a[i] == "first":
                first = val
            elif a[i] == "last":
                last = val
            elif a[i] == "every":
                every = val
            else:
                skip = val
            i += 2
        if not files or fields is None:
            raise ValueError("Illegal rerun command: files and dump fields")
        nframe = 0
        for fpath in files:
            for fr in read_dump_frames(os.path.join(self.root, fpath)):
                if fr[0] < first or fr[0] > last:
                    continue
                if every and fr[0] % every != 0:
                    continue
                nframe += 1
                if (nframe - 1) % skip != 0:
                    continue
                self._apply_dump_frame(fr, fields)
                t0 = time.perf_counter()
                self._sim = Simulation.from_script(self)
                _sync(self.device)
                t1 = time.perf_counter()
                self._run(0)
                t2 = time.perf_counter()
                self.rerun_timings.append((1e3 * (t1 - t0),
                                           1e3 * (t2 - t1)))

    def cmd_run(self, a):
        nsteps = int(a[0])
        if len(a) > 1:
            if a[1] != "upto" or len(a) > 2:
                _unported(f"run keywords {' '.join(a[1:])}")
            nsteps = max(0, nsteps - int(self.step))
        every = self._restart_every
        if every <= 0:
            self._run(nsteps)
            return
        # restart N: the run in chunks that end on the N-step grid, a
        # checkpoint after each that lands on it (output.cpp
        # write_restart), alternating between the names; the time
        # functions span the whole run, and each step's row prints once
        # (the later chunks print no start row), as in the JAX package
        self._run_begin = int(self.step)
        self._run_end = int(self.step) + nsteps
        self._in_run = True
        k = self._restart_toggle
        first = True
        try:
            while nsteps > 0:
                seg = min(every - (self.step % every) or every, nsteps)
                self._suppress_start_row = not first
                self._run(seg)
                first = False
                nsteps -= seg
                if self.step % every == 0:
                    files = self._restart_files
                    self.cmd_write_restart([files[k % len(files)]])
                    k += 1
        finally:
            self._suppress_start_row = False
            self._restart_toggle = k
            self._in_run = False

    def _run(self, nsteps: int):
        from lidp_tpu_torch.sim import Simulation

        if self._sim is None:
            self._sim = Simulation.from_script(self)
        # a chunk of a restart-segmented run keeps the whole run's span
        nested = self._in_run
        if not nested:
            self._run_begin = int(self.step)
            self._run_end = int(self.step) + int(nsteps)
        self._in_run = True
        try:
            self._sim.run(nsteps)
        finally:
            self._in_run = nested


class _ExprCtx:
    """Evaluation context: io/expr.py <-> LammpsScript.  The callbacks the
    expression engine needs (thermo keywords, variable references, group
    functions, atom vectors, the random streams) against the script's
    host state — the Variable::evaluate environment (variable.cpp:1168).
    A compute's c_ID or c_ID[i] reads the current thermo row, a vector
    special fix vector's series or a compute's c_ID[1..]; v_NAME of an
    atom-style variable gives its per-atom values; f_ID (which JAX's
    thermo row never holds) raises."""

    def __init__(self, script):
        self.s = script

    @property
    def natoms(self):
        return 0 if self.s.x is None else len(self.s.x)

    @property
    def step(self):
        # a thermo row being formed gives its own step (the JAX package's
        # _ExprCtx.step): ramp() and the v_NAME columns inside a run
        row = self.s._kw_row
        if row is not None and "step" in row:
            return int(row["step"])
        return int(self.s.step)

    @property
    def dt(self):
        return float(self.s.dt)

    @property
    def in_run(self):
        return bool(self.s._in_run)

    @property
    def run_begin(self):
        return int(self.s._run_begin)

    @property
    def run_end(self):
        return int(self.s._run_end)

    def thermo(self, word):
        return self.s._thermo_keyword(word)

    def var_ref(self, name, mode):
        """v_NAME: an atom-style variable's values (the vector, or atom
        `mode`'s), refused in an equal-style formula; else the value."""
        s = self.s
        if name in s._atom_exprs:
            if mode is None:
                raise ValueError(
                    f"atom-style variable {name} in equal-style formula")
            arr = s.evaluate_atom_expr(s._atom_exprs[name])
            return arr if mode == "vec" else float(arr[mode])
        return s.var_value(name)

    def compute_ref(self, cid, i1, i2, mode):
        """c_ID or c_ID[i] of a global compute: its value in the current
        thermo row (the JAX package's lookup)."""
        key = f"c_{cid}"
        if i1 is not None:
            key += f"[{i1}]"
        if i2 is not None:
            key += f"[{i2}]"
        row = self.s._current_thermo_row()
        if row is not None and key in row:
            return float(row[key])
        raise ValueError(f"compute reference {key} not available in "
                         "variable formula (no live value)")

    def fix_ref(self, fid, i1, i2, mode):
        """f_ID: the JAX package looks it up in its thermo row, which holds
        fix cmap's energy (its f_ID column) and no other fix's value; the
        port raises for the others."""
        key = f"f_{fid}" + (f"[{i1}]" if i1 is not None else "")
        if i1 is None and self.s._is_cmap_fix(fid):
            row = self.s._current_thermo_row()
            if row is not None and key in row:
                return float(row[key])
        _unported(f"fix reference {key} (JAX's thermo row has no fix's "
                  "value)", _NO_VALUE)

    def atom_vec(self, word):
        s = self.s
        n = self.natoms
        if word == "id":
            return np.arange(1, n + 1, dtype=float)
        if word == "mass":
            return s.mass_type[s.type].astype(float)
        if word in ("type", "mol", "q"):
            return np.asarray(getattr(s, word), float)
        if word in ("x", "y", "z"):
            return np.asarray(s.x, float)[:, "xyz".index(word)]
        if word in ("vx", "vy", "vz"):
            return np.asarray(s.v, float)[:, "xyz".index(word[1])]
        if word in ("fx", "fy", "fz"):
            return self._forces()[:, "xyz".index(word[1])]
        raise ValueError(f"unknown atom vector {word!r}")

    def group_mask(self, name):
        return np.asarray(self.s.groups[name], bool)

    def region_mask(self, name):
        return np.asarray(self.s._region_mask(name), bool)

    def group_func(self, word, raw):
        """Group functions (variable.cpp:3669-3911) on the host arrays."""
        s = self.s
        gm = self.group_mask(raw[0])
        if len(raw) > 2 and raw[1].startswith("region"):
            _unported("group function region argument", _BREADTH)
        m = s.mass_type[s.type].astype(float)[gm]
        x = np.asarray(s.x, float)[gm]
        v = np.asarray(s.v, float)[gm]
        if word == "count":
            return float(gm.sum())
        if word == "mass":
            return float(m.sum())
        if word == "charge":
            return float(np.asarray(s.q, float)[gm].sum())
        if word == "ke":
            return float(0.5 * s.units.mvv2e * (m[:, None] * v * v).sum())
        # unwrapped coordinates (group.cpp uses image-corrected positions)
        L = (s.box_hi - s.box_lo).astype(float)
        x = x + np.asarray(s.image, float)[gm] * L[None, :]
        M = m.sum()
        xcm = (m[:, None] * x).sum(0) / M
        dim = {"x": 0, "y": 1, "z": 2}
        if word == "xcm":
            return float(xcm[dim[raw[1]]])
        if word == "vcm":
            return float(((m[:, None] * v).sum(0) / M)[dim[raw[1]]])
        if word == "fcm":
            return float(self._forces()[gm].sum(0)[dim[raw[1]]])
        if word == "bound":
            col = np.asarray(s.x, float)[gm][:, dim[raw[1][0]]]
            return float(col.min() if raw[1].endswith("min")
                         else col.max())
        if word == "gyration":
            d2 = ((x - xcm) ** 2).sum(1)
            return float(np.sqrt((m * d2).sum() / M))
        _unported(f"group function {word}", _BREADTH)

    def _forces(self):
        sim = self.s._sim
        n = self.natoms
        if sim is not None and sim.res is not None:
            return sim.res.f[:n].double().cpu().numpy()
        return np.zeros((n, 3))

    def special_vector(self, tok):
        """A global vector for the special functions (slope, ave, ...):
        fix vector's series (fix_vector.cpp compute_vector), else the
        c_ID[1], c_ID[2], ... values of the current thermo row."""
        m = re.match(r"^([cfv])_(\w+)$", tok)
        if not m:
            raise ValueError(f"invalid vector reference {tok!r}")
        if m.group(1) == "f":
            spec = self.s.fixes.get(m.group(2))
            if spec is None or spec.style != "vector":
                _unported(f"vector reference {tok} (a fix other than fix "
                          "vector)", _NO_VALUE)
            buf = getattr(spec, "_series", None)
            if not buf:
                raise ValueError(f"fix vector {m.group(2)} has no values "
                                 "yet")
            return np.asarray(buf, float)
        row = self.s._current_thermo_row()
        if row is None:
            raise ValueError("no live values for vector special function")
        key = {"c": "c_", "v": "v_"}[m.group(1)] + m.group(2)
        vals = []
        i = 1
        while f"{key}[{i}]" in row:
            vals.append(float(row[f"{key}[{i}]"]))
            i += 1
        if not vals:
            raise ValueError(f"vector reference {tok!r} has no values")
        return np.asarray(vals)

    def random_source(self, seed, atom):
        """The persistent RanMars stream of random()/normal(): one for
        equal-style formulas, one for atom-style ones, each seeded by its
        first call (the JAX package's variable streams)."""
        from lidp_tpu_torch.rng import RanMars

        s = self.s
        name = "_rng_atom" if atom else "_rng_equal"
        if getattr(s, name) is None:
            setattr(s, name, RanMars(seed))
        return getattr(s, name)

    def var_next(self, names):
        # next(v): the current value, then advance (variable.cpp special
        # next); advancing deletes exhausted variables
        s = self.s
        vals = [s.var_value(n) for n in names]
        for n in names:
            seq = s._index_values.get(n)
            if seq is not None and s.variables.get(n) in seq[:-1]:
                i = seq.index(s.variables[n])
                s.variables[n] = seq[i + 1]
            else:
                s.variables.pop(n, None)
                s._index_values.pop(n, None)
        return vals[0]

    def is_defined(self, raw):
        if len(raw) != 2:
            raise ValueError("is_defined(category,id) needs 2 args")
        cat, ident = raw
        s = self.s
        if cat == "variable":
            return float(ident in s.variables or ident in s._equal_exprs
                         or ident in s._atom_exprs
                         or ident in s._internal_vars)
        if cat == "compute":
            return float(ident in s.computes)
        if cat == "fix":
            return float(ident in s.fixes)
        if cat == "dump":
            return float(ident in s.dumps)
        return 0.0

    def is_active(self, name, raw):
        _unported(f"{name}() special function")
