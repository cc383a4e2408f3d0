"""Library / scripting API (lidp_tpu/api.py): the analog of the
reference's C library interface (src/library.cpp) and its Python wrapper
(python/lammps.py), the class `lammps` and PyLammps with the same method
names and semantics, driving the port's LammpsScript in this process.

Some computes are read only here: compute rdf's (Nbin, 3) array comes
through extract_compute, and msd, vacf, heat/flux and a one-column compute
slice come back as vectors, temp/chunk without values as a scalar (the
JAX package's extract_compute reads them from the thermo row, and no
*/chunk array or per-atom column).  A
`lammps` runs on the GPU unless device="cpu" is given, and raises without
one.  set_fix_external_callback and fix_external_set_force feed fix
external (styles/fix_modifiers.py build_external).
"""

from __future__ import annotations

import numpy as np
import torch

__version__ = 20260816   # date-coded like lammps_version (library.cpp)



class lammps:
    """In-process lidp_tpu_torch instance driven by LAMMPS commands
    (python/lammps.py: class lammps(name='', cmdargs=None)).  cmdargs:
    the CLI flags -log, -var name value (-echo and -screen are read and
    ignored, as in the JAX package); dtype: the runs' float type (float64
    by default); device: "cuda" (the default) or "cpu"."""

    def __init__(self, name: str = "", cmdargs=None, dtype=torch.float64,
                 device="cuda"):
        from lidp_tpu_torch.io.script import LammpsScript

        log = None
        self._var_overrides = {}
        args = list(cmdargs or [])
        i = 0
        while i < len(args):
            a = args[i]
            if a in ("-log", "-l"):
                log = args[i + 1]
                i += 2
            elif a in ("-var", "-v"):
                self._var_overrides[args[i + 1]] = args[i + 2]
                i += 3
            elif a in ("-echo", "-e", "-screen", "-sc"):
                i += 2
            else:
                i += 1
        self._log_fh = None
        logfn = None
        if log and log != "none":
            self._log_fh = open(log, "w")

            def logfn(s):
                self._log_fh.write(s + "\n")
                self._log_fh.flush()

        self.lmp = LammpsScript(dtype=dtype, device=device, log=logfn)
        for k, v in self._var_overrides.items():
            self.lmp.variables[k] = v

    # ---- lifecycle -------------------------------------------------------
    def close(self):
        """lammps_close (python/lammps.py:86)."""
        if self._log_fh:
            self._log_fh.close()
            self._log_fh = None
        self.lmp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def version(self) -> int:
        """lammps_version (python/lammps.py:92)."""
        return __version__

    # ---- command input ---------------------------------------------------
    def file(self, path: str):
        """Run an entire input script (lammps_file)."""
        self.lmp.file(path)

    def command(self, cmd: str):
        """Execute one command (lammps_command)."""
        self.lmp.one(cmd)

    def commands_list(self, cmdlist):
        """python/lammps.py commands_list."""
        self.lmp.execute(list(cmdlist))

    def commands_string(self, multicmd: str):
        """python/lammps.py commands_string."""
        self.lmp.execute(multicmd.splitlines())

    # ---- global state ----------------------------------------------------
    def get_natoms(self) -> int:
        """lammps_get_natoms (python/lammps.py:237)."""
        return 0 if self.lmp.x is None else int(self.lmp.x.shape[0])

    def _external(self, fix_id: str):
        spec = self.lmp.fixes.get(fix_id)
        if spec is None or spec.style != "external":
            raise ValueError(f"Fix {fix_id} is not a fix external")
        return spec

    def set_fix_external_callback(self, fix_id: str, func, caller=None):
        """lammps_set_fix_external_callback (library.cpp): the force
        provider of `fix ID group external pf/callback Ncall Napply`,
        func(caller, step, nlocal, ids, x, fexternal), which fills
        fexternal (nlocal, 3) in place; called on the Ncall grid at the
        run's setup and on its steps, with that step's positions.  The
        Simulation is rebuilt at the next run."""
        spec = self._external(fix_id)
        spec._callback = func
        spec._caller = caller
        self.lmp._invalidate()

    def fix_external_set_force(self, fix_id: str, f):
        """FixExternal::set_force analog: the (natoms, 3) per-atom forces
        of a `fix external pf/array` fix, from the next run on."""
        spec = self._external(fix_id)
        spec._fexternal = np.asarray(f, float)
        self.lmp._invalidate()

    def get_thermo(self, name: str) -> float:
        """A thermo keyword's value on the current state (lammps_get_thermo;
        a `run 0` sets up the forces first when no run has)."""
        row = self._thermo()
        if name not in row:
            raise KeyError(f"unknown thermo keyword {name!r}; "
                           f"have {sorted(row)}")
        return float(row[name])

    def _thermo(self) -> dict:
        sim = self._sim()
        if sim.res is None:
            sim.run(0)
        return sim.thermo_row()

    def _sim(self):
        from lidp_tpu_torch.sim import Simulation

        if self.lmp._sim is None:
            self.lmp._sim = Simulation.from_script(self.lmp)
        return self.lmp._sim

    def extract_global(self, name: str, _type=None):
        """Scalar globals (lammps_extract_global: dt, ntimestep, natoms,
        ntypes, the box bounds, the unit constants)."""
        s = self.lmp
        u = s.units
        vals = {
            "dt": s.dt, "ntimestep": int(s.step), "natoms": self.get_natoms(),
            "ntypes": int(s.ntypes),
            "boxxlo": float(s.box_lo[0]), "boxxhi": float(s.box_hi[0]),
            "boxylo": float(s.box_lo[1]), "boxyhi": float(s.box_hi[1]),
            "boxzlo": float(s.box_lo[2]), "boxzhi": float(s.box_hi[2]),
            "boltz": u.boltz, "mvv2e": u.mvv2e, "ftm2v": u.ftm2v,
            "qqr2e": u.qqr2e, "nktv2p": u.nktv2p,
        }
        if name not in vals:
            raise KeyError(f"unknown global {name!r}")
        return vals[name]

    def extract_box(self):
        """(boxlo, boxhi, xy, yz, xz, periodicity, box_change)
        (python/lammps.py:150); the port's box is orthogonal."""
        s = self.lmp
        per = [1 if st[0] == "p" else 0 for st in s.boundary_styles]
        return (list(map(float, s.box_lo)), list(map(float, s.box_hi)),
                0.0, 0.0, 0.0, per, 0)

    # ---- per-atom data ---------------------------------------------------
    _ATOM_FIELDS = ("x", "v", "f", "q", "type", "mol", "id", "mass", "image",
                    "mu", "static_polarizability")

    def extract_atom(self, name: str, _type=None) -> np.ndarray:
        """A per-atom array's snapshot in id order (lammps_extract_atom;
        the fork adds static_polarizability and mu_induced, atom.h:161),
        a float64 or int64 numpy copy; mass is per type, as in LAMMPS."""
        s = self.lmp
        sim = s._sim
        sysv = sim.sys if sim is not None else None
        n = self.get_natoms()

        def host(t):
            return t[:n].double().cpu().numpy()

        if name == "id":
            return np.arange(1, n + 1, dtype=np.int64)
        if name in ("x", "v", "q"):
            return (host(getattr(sysv, name)) if sysv is not None
                    else np.asarray(getattr(s, name), np.float64))
        if name == "f":
            if sim is None or sim.res is None:
                self._thermo()
                sim = s._sim
            return host(sim.res.f)
        if name == "type":
            return np.asarray(s.type, np.int64)
        if name in ("mol", "molecule"):
            return np.asarray(s.mol, np.int64)
        if name == "mass":
            return np.asarray(s.mass_type, np.float64)
        if name == "image":
            return (sysv.image[:n].cpu().numpy().astype(np.int64)
                    if sysv is not None else np.zeros((n, 3), np.int64))
        if name in ("mu", "mu_induced"):
            return host(sysv.mu) if sysv is not None else np.zeros((n, 3))
        if name in ("static_polarizability", "alpha"):
            return np.asarray(s.alpha_type[s.type], np.float64)
        raise KeyError(f"unknown per-atom field {name!r}; "
                       f"have {self._ATOM_FIELDS}")

    def gather_atoms(self, name: str, _type=None, _count=None) -> np.ndarray:
        """lammps_gather_atoms: one process, the same as extract_atom."""
        return self.extract_atom(name)

    def scatter_atoms(self, name: str, data, _type=None, _count=None):
        """Write per-atom data back (lammps_scatter_atoms): x, v and q
        into the host arrays and a live Simulation (its forces then stale,
        set up again at the next run), type by rebuilding it."""
        s = self.lmp
        arr = np.asarray(data)
        n = self.get_natoms()
        if arr.shape[0] != n:
            raise ValueError(f"scatter_atoms {name}: got {arr.shape[0]} rows "
                             f"for {n} atoms")
        if name in ("x", "v", "q"):
            setattr(s, name, arr.astype(np.float64))
            if s._sim is not None:
                sim = s._sim
                t = getattr(sim.sys, name).clone()
                t[:n] = torch.as_tensor(arr, dtype=t.dtype, device=t.device)
                sim.sys = sim.sys.replace(**{name: t})
                sim.res = None
        elif name == "type":
            s.type = arr.astype(np.int32)
            s._sim = None
        else:
            raise KeyError(f"scatter_atoms: unsupported field {name!r}")

    # ---- variables / computes --------------------------------------------
    def extract_variable(self, name: str, group=None, _type=None):
        """python/lammps.py:207 extract_variable: an equal-style variable's
        value now; index, loop and string styles their string."""
        try:
            return float(self.lmp.var_value(name))
        except KeyError:
            raise KeyError(f"no variable {name!r}")
        except ValueError:
            return self.lmp.variables.get(name)

    def set_variable(self, name: str, value) -> int:
        """python/lammps.py:252 set_variable."""
        self.lmp.variables[name] = str(value)
        return 0

    def extract_compute(self, cid: str, style=None, _type=None):
        """lammps_extract_compute: a scalar (temp, pe, group/group,
        temp/chunk's, ...), a vector (msd, vacf, com, heat/flux, a
        one-column slice: its components) or compute rdf's (Nbin, 3)
        array [r, g(r), coord], on the current state."""
        sim = self._sim()
        if cid in sim.rdf_computes:
            if sim.res is None:
                sim.run(0)
            return sim.compute_rdf(cid)
        row = self._thermo()
        if f"c_{cid}[1]" in row:
            out = []
            k = 1
            while f"c_{cid}[{k}]" in row:
                out.append(float(row[f"c_{cid}[{k}]"]))
                k += 1
            return np.asarray(out)
        key = "c_" + cid
        if key not in row:
            raise KeyError(f"no compute {cid!r}")
        return float(row[key])


class PyLammps:
    """python/lammps.py's PyLammps: commands as attributes
    (L.pair_style(...), L.run(10)), a `lammps` underneath."""

    def __init__(self, name: str = "", cmdargs=None, device="cuda"):
        self.lmp = lammps(name, cmdargs, device=device)

    def __getattr__(self, cmd):
        if cmd.startswith("_"):
            raise AttributeError(cmd)

        def call(*args):
            self.lmp.command(" ".join([cmd] + [str(a) for a in args]))

        return call

    @property
    def atoms(self):
        return self.lmp.get_natoms()

    def eval(self, expr: str) -> float:
        return self.lmp.get_thermo(expr)
