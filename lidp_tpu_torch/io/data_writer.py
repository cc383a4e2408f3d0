"""LAMMPS data-file writer — the inverse of io/data_reader.py
(write_data.cpp: header + Masses + Atoms + Velocities + the Bonds, Angles,
Dihedrals and Impropers sections; lidp_tpu/io/data_writer.py, an own copy
reading the port's tensors).  As in the JAX package, the Atoms section of
every style but full takes the atomic layout `id type x y z`, which a
bond, angle or molecular reader does not take back (ROADMAP queue 3).

State is taken from the live Simulation if one exists (post-run coordinates)
else from the interpreter arrays.
"""

from __future__ import annotations

import numpy as np


def write_data(path: str, script):
    sim = getattr(script, "_sim", None)
    if sim is not None and sim.sys is not None:
        x = sim.sys.x[:sim.natoms].double().cpu().numpy()
        v = sim.sys.v[:sim.natoms].double().cpu().numpy()
        lo = sim.sys.box.lo.double().cpu().numpy()
        hi = sim.sys.box.hi.double().cpu().numpy()
        # wrap into the (possibly barostat-changed) box like write_data.cpp
        L = hi - lo
        x = x - np.floor((x - lo) / L) * L
    else:
        x = np.asarray(script.x)
        v = (np.asarray(script.v) if script.v is not None
             else np.zeros_like(x))
        lo, hi = script.box_lo, script.box_hi
    n = x.shape[0]
    q = script.q if script.q is not None else np.zeros(n)
    mol = script.mol if script.mol is not None else np.zeros(n, int)
    full = script.atom_style == "full"

    sections = (("bonds", script._bonds, script._bond_types,
                 script.bond_coeffs),
                ("angles", script._angles, script._angle_types,
                 script.angle_coeffs),
                ("dihedrals", script._dihedrals, script._dihedral_types,
                 script.dihedral_coeffs),
                ("impropers", script._impropers, script._improper_types,
                 script.improper_coeffs))
    sections = [sec for sec in sections
                if sec[1] is not None and len(sec[1])]

    with open(path, "w") as fh:
        fh.write("LAMMPS data file via lidp_tpu_torch write_data\n\n")
        fh.write(f"{n} atoms\n")
        fh.write(f"{script.ntypes} atom types\n")
        for name, arr, _, coeffs in sections:
            fh.write(f"{len(arr)} {name}\n")
            fh.write(f"{max(coeffs.keys(), default=1)} {name[:-1]} types\n")
        fh.write(f"\n{lo[0]:.16g} {hi[0]:.16g} xlo xhi\n")
        fh.write(f"{lo[1]:.16g} {hi[1]:.16g} ylo yhi\n")
        fh.write(f"{lo[2]:.16g} {hi[2]:.16g} zlo zhi\n")
        if script.mass_type is not None:
            fh.write("\nMasses\n\n")
            for t in range(1, script.ntypes + 1):
                fh.write(f"{t} {script.mass_type[t]:.16g}\n")
        fh.write("\nAtoms\n\n")
        for i in range(n):
            if full:
                fh.write(f"{i+1} {int(mol[i])} {int(script.type[i])} "
                         f"{q[i]:.16g} {x[i,0]:.16g} {x[i,1]:.16g} "
                         f"{x[i,2]:.16g}\n")
            else:
                fh.write(f"{i+1} {int(script.type[i])} "
                         f"{x[i,0]:.16g} {x[i,1]:.16g} {x[i,2]:.16g}\n")
        fh.write("\nVelocities\n\n")
        for i in range(n):
            fh.write(f"{i+1} {v[i,0]:.16g} {v[i,1]:.16g} {v[i,2]:.16g}\n")
        for name, arr, types, _ in sections:
            fh.write(f"\n{name.capitalize()}\n\n")
            for k, row in enumerate(np.asarray(arr)):
                t = int(types[k]) if types is not None else 1
                fh.write(f"{k+1} {t} "
                         + " ".join(str(int(b)) for b in row) + "\n")
