"""LAMMPS input-script interpreter (lidp_tpu/io/script.py, the commands of
the polarizable main path).

The reference's Input::file/one dispatch (input.cpp:151,286,761) with
$-substitution (input.cpp:330), equal-style variables through io/expr.py,
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
styles/fix_modifiers.py, and bench/in.eam (pair_style eam, eam/alloy and
eam/fs with their potential files; set type/fraction);
every other command, style or keyword raises NotImplementedError naming
itself and the ROADMAP item that ports it, and is never ignored.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shlex
from typing import Optional

import numpy as np
import torch

from lidp_tpu_torch import resolve_device
from lidp_tpu_torch import units as units_mod
from lidp_tpu_torch import velocity as velocity_mod
from lidp_tpu_torch.io import expr as expr_mod
from lidp_tpu_torch.io.data_reader import read_data

# bare-number detector for optional positional args (the pair_style
# polarization grammar's optional cut_coul before keywords)
_NUM_RE = re.compile(r"^[\d eE+\-*/().]+$")

# where the commands, styles and keywords this interpreter lacks are queued
_FRONT_END = "ROADMAP queue 1 item 4, the script front end"
_BREADTH = "ROADMAP queue 1 item 6, breadth"

# thermo keywords the port's thermo row gives (thermo.thermo_row and
# Simulation._thermo_row)
THERMO_KEYWORDS = frozenset((
    "step", "temp", "ke", "pe", "etotal", "evdwl", "ecoul", "elong", "epol",
    "epair", "emol", "ebond", "eangle", "edihed", "eimp", "press", "vol",
    "density", "lx", "ly", "lz", "xlo", "ylo", "zlo", "xhi", "yhi", "zhi",
    "xy", "xz", "yz", "atoms", "bonds"))

# pair styles Simulation.from_script builds
PAIR_STYLES = ("lj/cut", "lj/cut/coul/long", "lj/cut/coul/long/polarization",
               "lj/charmm/coul/long", "lj/charmm/coul/charmm")
# the many-body styles (ops/eam.py): the cutoff comes from the potential
# file that pair_coeff names
EAM_STYLES = ("eam", "eam/alloy", "eam/fs")
# the CHARMM pair styles the JAX package runs and the port does not
CHARMM_UNPORTED = ("lj/charmm/coul/charmm/implicit", "lj/charmm/coul/msm",
                   "lj/charmmfsw/coul/long", "lj/charmmfsw/coul/charmmfsh")

# fix styles with a builder (styles/fix_integrators.py, fix_modifiers.py)
FIX_STYLES = ("nve", "nvt", "npt", "nph", "rigid", "rigid/nve", "rigid/nvt",
              "rigid/npt", "rigid/nph", "rigid/small", "rigid/nve/small",
              "rigid/nvt/small", "rigid/npt/small", "rigid/nph/small",
              "shake", "rattle", "langevin", "setforce", "addforce",
              "aveforce", "spring", "spring/self", "viscous", "efield",
              "planeforce", "lineforce", "momentum", "recenter",
              "temp/rescale", "temp/berendsen", "temp/csld")
# where the fix styles the port lacks are queued: the modifier fixes of
# the JAX package's styles/fix_modifiers.py, and the others by their item
_MODIFIERS = "ROADMAP queue 1 item 6.1, the modifier fixes"
_FIX_ITEMS = {
    "enforce2d": "ROADMAP queue 1 item 6.2, minimize and 2d",
    "cmap": "ROADMAP queue 1 item 6.6, the CHARMM family",
    "nvt/sllod": "ROADMAP queue 1 item 6.8, integrator keywords",
    "nvt/sphere": "ROADMAP queue 1 item 6.8, integrator keywords",
    "npt/sphere": "ROADMAP queue 1 item 6.8, integrator keywords",
    "nph/sphere": "ROADMAP queue 1 item 6.8, integrator keywords",
    "wall/gran": "ROADMAP queue 1 item 6.11, granular",
    "wall/gran/region": "ROADMAP queue 1 item 6.11, granular",
    "pour": "ROADMAP queue 1 item 6.11, granular",
    "nve/sphere": "ROADMAP queue 1 item 6.11, granular",
}

# the bonded styles (ops/bonded.py, styles/bonded_builders.py); dihedral
# charmmfsw pairs with lj/charmmfsw, which is not ported
BOND_STYLES = ("harmonic", "fene", "fene/expand", "morse", "nonlinear",
               "gromos", "quartic", "table", "zero", "hybrid")
ANGLE_STYLES = ("harmonic", "charmm", "cosine", "cosine/squared",
                "cosine/delta", "cosine/periodic", "table", "zero", "hybrid")
DIHEDRAL_STYLES = ("opls", "harmonic", "charmm", "multi/harmonic", "helix",
                   "zero", "hybrid")
IMPROPER_STYLES = ("harmonic", "cvff", "umbrella", "zero", "hybrid")


def _unported(what: str, where: str = _FRONT_END):
    raise NotImplementedError(f"{what} is not ported ({where})")


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


class LammpsScript:
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
        self._eval_in_progress: set = set()
        self._rng_equal = None       # persistent random() stream
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
        self.atom_style = "atomic"
        self.dimension = 3
        self.periodic = (True, True, True)
        self.data = None             # DataFile
        self.lattice_style = None
        self.lattice_spacing3 = None   # (3,) of the lattice command
        # region ID -> (xlo, xhi, ylo, yhi, zlo, zhi) of a block, in the
        # region's units; region ID -> {"side": in|out, "units": ...}
        self.regions: dict[str, tuple] = {}
        self._region_kw: dict[str, dict] = {}
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
        self._gewald_override = None  # kspace_modify gewald
        self._thermo_norm = None
        self._thermo_float_format = None

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
        equal style evaluates NOW and formats %.15g (variable.cpp:856)."""
        if name in self._equal_exprs:
            return "%.15g" % self.var_value(name)
        return self.variables.get(name)

    def var_value(self, name) -> float:
        """Numeric value of a variable (equal evaluated lazily; index,
        loop and string parsed as numbers)."""
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

    def _thermo_keyword(self, word):
        """Thermo::evaluate_keyword analog for expressions: geometry and
        configuration keywords from the host state, state keywords from
        the live Simulation's thermo row."""
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
        if self._sim is not None and self._sim.res is not None:
            return self._sim._thermo_row()
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
                      self._equal_exprs):
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
        elif style == "string":
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
        if any(tok != "p" for tok in a):
            _unported(f"boundary {' '.join(a)} (p p p only)", _BREADTH)

    def cmd_atom_style(self, a):
        # bond, angle and molecular read `id mol type x y z` (no charge)
        if a[0] not in ("atomic", "full", "charge", "bond", "angle",
                        "molecular"):
            _unported(f"atom_style {a[0]} (atomic, charge, bond, angle, "
                      "molecular and full only)", _FRONT_END)
        self.atom_style = a[0]

    def cmd_dimension(self, a):
        if int(a[0]) != 3:
            _unported(f"dimension {a[0]}", _BREADTH)

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
        exclude molecule|molecule/intra all | exclude type I J
        (neighbor.cpp modify_params); one and page size the reference's
        list pages, which the cell grid does not have.  An excluded pair
        takes no pair term (the JAX package masks it out of every pair
        pass); exclude group and exclusions on a sub-group raise."""
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

    def cmd_region(self, a):
        """region ID block xlo xhi ylo yhi zlo zhi [side in|out] [units
        lattice|box] (region.cpp options, region_block.cpp)."""
        name, style = a[0], a[1]
        if style != "block":
            _unported(f"region style {style} (block only)", _BREADTH)
        self.regions[name] = tuple(float(v) for v in a[2:8])
        kw = {"side": "in", "units": "lattice"}
        i = 8
        while i < len(a):
            if a[i] == "side" and a[i + 1] in ("in", "out"):
                kw["side"] = a[i + 1]
            elif a[i] == "units" and a[i + 1] in ("lattice", "box"):
                kw["units"] = a[i + 1]
            else:
                _unported(f"region keyword {' '.join(a[i:i + 2])}", _BREADTH)
            i += 2
        self._region_kw[name] = kw

    def _region_mask(self, name, x):
        """Which of the points x lie in block region `name` (bounds
        inclusive, region_block.cpp inside(); side out inverts)."""
        kw = self._region_kw[name]
        s3 = np.ones(3) if kw["units"] == "box" else self._spacing3()
        lo_hi = np.asarray(self.regions[name], float) * np.repeat(s3, 2)
        sel = np.ones(x.shape[0], bool)
        for d in range(3):
            # INF as a lower bound is minus infinity
            lo = -np.inf if np.isinf(lo_hi[2 * d]) else lo_hi[2 * d]
            sel &= (x[:, d] >= lo) & (x[:, d] <= lo_hi[2 * d + 1])
        return ~sel if kw["side"] == "out" else sel

    def cmd_create_box(self, a):
        """create_box N region-ID (create_box.cpp), orthogonal: the box of
        the block scaled by the lattice spacings, as the JAX package's
        create_box scales it whatever the region's units (ROADMAP queue 3
        item 6)."""
        if len(a) > 2:
            _unported(f"create_box keywords {' '.join(a[2:])}", _BREADTH)
        self.ntypes = int(a[0])
        b = np.asarray(self.regions[a[1]], float)
        s3 = self._spacing3()
        self.box_lo = b[0::2] * s3
        self.box_hi = b[1::2] * s3
        self.box_tilt = None
        self.mass_type = np.zeros(self.ntypes + 1)
        self.alpha_type = np.zeros(self.ntypes + 1)

    def cmd_create_atoms(self, a):
        """create_atoms TYPE box | region ID | single x y z [units
        box|lattice] (create_atoms.cpp styles BOX, REGION, SINGLE): lattice
        sites in the order of lattice.create_atoms_bounds, the order the
        `velocity ... loop all` stream follows.  `box` replaces the atoms;
        `region` and `single` append to them."""
        from lidp_tpu_torch import lattice as lattice_mod

        ty = int(a[0])
        if a[1] in ("box", "region"):
            if self.lattice_style is None:
                raise ValueError("create_atoms: a lattice must be defined "
                                 "first")
            x = lattice_mod.create_atoms_bounds(
                self.lattice_style, self._spacing3(), self.box_lo,
                self.box_hi)
            if a[1] == "region":
                x = x[self._region_mask(a[2], x)]
            rest = a[3:] if a[1] == "region" else a[2:]
        elif a[1] == "single":
            units = "lattice"
            if len(a) > 5:
                if a[5] != "units" or a[6] not in ("box", "lattice"):
                    _unported(f"create_atoms keyword {a[5]}", _BREADTH)
                units = a[6]
            s3 = np.ones(3) if units == "box" else self._spacing3()
            x = np.array([[float(a[2]) * s3[0], float(a[3]) * s3[1],
                           float(a[4]) * s3[2]]])
            rest = a[7:]
        else:
            _unported(f"create_atoms {a[1]}", _BREADTH)
        if rest:
            _unported(f"create_atoms keywords {' '.join(rest)}", _BREADTH)
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
        if len(a) > 1:
            _unported(f"read_data keywords {' '.join(a[1:])}")
        d = read_data(os.path.join(self.root, a[0]),
                      atom_style=self.atom_style)
        if d.tilt is not None and np.any(d.tilt != 0.0):
            _unported("a triclinic box", _BREADTH)
        self.data = d
        self.ntypes = d.ntypes
        self.box_lo, self.box_hi = d.box_lo, d.box_hi
        self.box_tilt = d.tilt
        self.x, self.q = d.x, d.q
        self.type, self.mol, self.image = d.type, d.mol, d.image
        self.v = d.v if d.v is not None else np.zeros_like(d.x)
        self.mass_type = (d.mass if d.mass is not None
                          else np.zeros(d.ntypes + 1))
        self.alpha_type = np.zeros(d.ntypes + 1)
        self._bonds = d.bonds
        self._bond_types = d.bond_types
        self.nbondtypes = d.nbondtypes
        self._angles, self._angle_types = d.angles, d.angle_types
        self._dihedrals, self._dihedral_types = d.dihedrals, d.dihedral_types
        self._impropers, self._improper_types = d.impropers, d.improper_types
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
        else:
            _unported(f"set {' '.join(a)}", _BREADTH)

    def _set_selector(self, style, ident):
        """set.cpp selection styles: atom (id range), type, group."""
        n = len(self.x)
        if style == "group":
            return self.groups[ident].copy()
        if style == "type":
            return self.type == int(ident)
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
        lj/charmm/coul/long INNER OUTER [CUT_COUL] | lj/charmm/coul/charmm
        INNER OUTER [INNER_COUL OUTER_COUL] (the CHARMM styles mix
        arithmetically, as the JAX package sets them) | eam | eam/alloy |
        eam/fs."""
        self._invalidate()
        self.pair_coeffs = {}
        self.pair_coeffs14 = {}
        if a[0] in CHARMM_UNPORTED:
            _unported(f"pair_style {a[0]} (the JAX package runs it)",
                      _BREADTH)
        if a[0] not in PAIR_STYLES + EAM_STYLES:
            _unported(f"pair_style {a[0]}", _BREADTH)
        p = PairStyleSpec(name=a[0])
        if a[0] in EAM_STYLES:
            # no settings: the cutoff is the potential file's
            # (PairEAM::settings, pair_eam.cpp)
            if len(a) > 1:
                raise ValueError("Illegal pair_style command")
            self.pair = p
            return
        p.cut_lj_global = float(a[1])
        if a[0] == "lj/charmm/coul/long":
            # inner outer [coul-outer] (pair_lj_charmm_coul_long.cpp
            # settings)
            if len(a) not in (3, 4):
                raise ValueError("Illegal pair_style command")
            p.cut_lj_inner = float(a[1])
            p.cut_lj_global = float(a[2])
            p.cut_coul = float(a[3]) if len(a) > 3 else p.cut_lj_global
            self._pair_mix = "arithmetic"
            self.pair = p
            return
        if a[0] == "lj/charmm/coul/charmm":
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

    def cmd_pair_coeff(self, a):
        self._invalidate()
        if self.pair.name in EAM_STYLES:
            self._eam_coeff(a)
            return
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
            if fam == "dihedral" and a[0] == "charmmfsw":
                _unported("dihedral_style charmmfsw (with the lj/charmmfsw "
                          "pair styles; the JAX package runs it)", _BREADTH)
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
            elif a[i] == "table":
                pass   # erfc is evaluated by its polynomial (no tables)
            elif a[i] == "shift":
                # the LJ energy less its value at the cutoff (the pair
                # tables' offset)
                self._pair_shift = _yesno(a[i + 1])
            else:
                _unported(f"pair_modify {a[i]}", _BREADTH)
            i += 2

    def cmd_kspace_style(self, a):
        """kspace_style ewald | ewald/disp | pppm | pppm/cg | pppm/stagger
        ACCURACY; pppm/cg's restriction of the mesh to the charged atoms is
        a sparsity optimisation with the same result, so it runs as pppm
        (the JAX package's alias)."""
        if a[0] == "none":
            self.kspace = None
        elif a[0] in ("ewald", "ewald/disp", "pppm", "pppm/cg",
                      "pppm/stagger"):
            self.kspace = (a[0], float(a[1]))
        else:
            _unported(f"kspace_style {a[0]}", _BREADTH)

    def cmd_kspace_modify(self, a):
        """kspace_modify gewald G.  The JAX package ignores every other
        keyword (mesh, order, ...; ROADMAP queue 3 item 10); the port
        raises on them."""
        i = 0
        while i < len(a):
            if a[i] != "gewald":
                _unported(f"kspace_modify {a[i]} (the JAX package ignores "
                          "it: ROADMAP queue 3 item 10)", _BREADTH)
            self._gewald_override = float(a[i + 1])
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
        else:
            _unported(f"group style {a[1]}", _BREADTH)
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
                if "[" in c:
                    _unported(f"thermo keyword {c} (a compute's vector)")
                if c[2:] not in self.computes:
                    raise ValueError(f"thermo_style: compute {c[2:]} does "
                                     "not exist")
            elif c not in THERMO_KEYWORDS:
                _unported(f"thermo keyword {c}")
        self.thermo_columns = cols

    def cmd_thermo(self, a):
        self.thermo_every = int(a[0])

    def cmd_thermo_modify(self, a):
        i = 0
        while i < len(a):
            if a[i] == "norm":
                self._thermo_norm = _yesno(a[i + 1])
                i += 2
            elif a[i] == "format" and a[i + 1] in ("float", "none"):
                # thermo_modify format float FMT (thermo.cpp:586)
                self._thermo_float_format = (a[i + 2] if a[i + 1] == "float"
                                             else None)
                i += 3 if a[i + 1] == "float" else 2
            else:
                _unported(f"thermo_modify {' '.join(a[i:i + 2])}")

    def cmd_dump(self, a):
        from lidp_tpu_torch.io.dump import COLUMNS

        did, group, style, every = a[0], a[1], a[2], int(a[3])
        if style == "atom":
            # dump_atom.cpp default columns: id type xs ys zs
            cols = ["id", "type", "xs", "ys", "zs"]
        elif style == "custom":
            cols = a[5:]
            for c in cols:
                if c not in COLUMNS:
                    _unported(f"dump custom column {c}")
        else:
            _unported(f"dump style {style}")
        self.dumps[did] = DumpSpec(did=did, group=group, style=style,
                                   every=every,
                                   path=os.path.join(self.root, a[4]),
                                   columns=cols)

    def cmd_dump_modify(self, a):
        spec = self.dumps[a[0]]
        i = 1
        while i < len(a):
            if a[i] == "sort" and a[i + 1] == "id":
                i += 2   # the arrays are id-ordered
            elif a[i] == "format" and a[i + 1] == "float":
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
            # velocity group zero linear (velocity.cpp::zero_momentum)
            if a[2] != "linear":
                _unported(f"velocity zero {a[2]}", _BREADTH)
            m = self.mass_type[self.type][gm]
            self.v[gm] -= (m[:, None] * self.v[gm]).sum(0) / m.sum()
            return
        if a[1] != "create":
            _unported(f"velocity {a[1]}", _BREADTH)
        t_desired, seed = float(a[2]), int(a[3])
        # velocity.cpp options() defaults: dist uniform, loop all, mom yes,
        # rot no
        kw = dict(dist="uniform", loop="all", momentum=True, rotation=False)
        i = 4
        while i < len(a):
            k, v = a[i], a[i + 1]
            if k in ("dist", "loop"):
                kw[k] = v
            elif k == "mom":
                kw["momentum"] = _yesno(v)
            elif k == "rot":
                kw["rotation"] = _yesno(v)
            elif k != "units":
                _unported(f"velocity create keyword {k}", _BREADTH)
            i += 2
        self.v = velocity_mod.create(
            self.x, self.mass_type[self.type], t_desired, seed,
            units=self.units, image=self.image,
            box_lengths=self.box_hi - self.box_lo, dim=self.dimension,
            group=None if group == "all" else gm, v_prev=self.v, **kw)

    def cmd_fix(self, a):
        fid, group, style = a[0], a[1], a[2]
        if style not in FIX_STYLES:
            _unported(f"fix style {style}",
                      _FIX_ITEMS.get(style, _MODIFIERS))
        self.fixes[fid] = FixSpec(fid=fid, group=group, style=style,
                                  args=a[3:])
        self._invalidate()

    def cmd_compute(self, a):
        """compute ID group temp (compute_temp.cpp): the group's temperature,
        a thermo column and an expression's value as c_ID."""
        cid, group, style = a[0], a[1], a[2]
        if style != "temp":
            _unported(f"compute style {style}")
        if group not in self.groups:
            raise ValueError(f"compute {cid}: group {group} does not exist")
        self.computes[cid] = (group, style)

    def cmd_fix_modify(self, a):
        _unported(f"fix_modify {' '.join(a)}", _MODIFIERS)

    def cmd_unfix(self, a):
        self.fixes.pop(a[0], None)
        self._invalidate()

    def cmd_write_data(self, a):
        """write_data file — the inverse of read_data (write_data.cpp)."""
        from lidp_tpu_torch.io.data_writer import write_data

        write_data(os.path.join(self.root, a[0]), self)

    def cmd_run(self, a):
        nsteps = int(a[0])
        if len(a) > 1:
            if a[1] != "upto" or len(a) > 2:
                _unported(f"run keywords {' '.join(a[1:])}")
            nsteps = max(0, nsteps - int(self.step))
        self._run(nsteps)

    def _run(self, nsteps: int):
        from lidp_tpu_torch.sim import Simulation

        if self._sim is None:
            self._sim = Simulation.from_script(self)
        self._run_begin = int(self.step)
        self._run_end = int(self.step) + int(nsteps)
        self._in_run = True
        try:
            self._sim.run(nsteps)
        finally:
            self._in_run = False


class _ExprCtx:
    """Evaluation context: io/expr.py <-> LammpsScript.  The callbacks the
    expression engine needs (thermo keywords, variable references, group
    functions, atom vectors, the random stream) against the script's host
    state — the Variable::evaluate environment (variable.cpp:1168).
    A temp compute's c_ID reads the current thermo row; fix references,
    regions, vector specials and atom-style variables are not ported and
    raise."""

    def __init__(self, script):
        self.s = script

    @property
    def natoms(self):
        return 0 if self.s.x is None else len(self.s.x)

    @property
    def step(self):
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
        if mode is not None:
            _unported(f"atom-style variable reference v_{name}", _BREADTH)
        return self.s.var_value(name)

    def compute_ref(self, cid, i1, i2, mode):
        """c_ID of a temp compute: its value in the current thermo row."""
        if i1 is not None or i2 is not None:
            _unported(f"compute reference c_{cid} with an index")
        row = self.s._current_thermo_row()
        if row is not None and f"c_{cid}" in row:
            return float(row[f"c_{cid}"])
        raise ValueError(f"compute reference c_{cid} not available in "
                         "variable formula (no live value)")

    def fix_ref(self, fid, i1, i2, mode):
        _unported(f"fix reference f_{fid}")

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
        _unported("regions", _BREADTH)

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
        _unported(f"vector reference {tok}")

    def random_source(self, seed, atom):
        if atom:
            _unported("atom-style random()", _BREADTH)
        s = self.s
        if s._rng_equal is None:
            from lidp_tpu_torch.rng import RanMars
            s._rng_equal = RanMars(seed)
        return s._rng_equal

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
            return float(ident in s.variables or ident in s._equal_exprs)
        if cat == "fix":
            return float(ident in s.fixes)
        if cat == "dump":
            return float(ident in s.dumps)
        return 0.0

    def is_active(self, name, raw):
        _unported(f"{name}() special function")
