"""LAMMPS data-file reader (``read_data`` command; lidp_tpu/io/data_reader.py,
an own copy).  The Atoms section's rows are parsed by the C++ helper
(native.parse_atoms) for every style but sphere; `native=False` takes the
Python row loop, the plain version the tests hold the helper to.

Parses the subset used by the reference's examples and benchmarks
(read_data.cpp:119): header (counts, types, box bounds), Masses, Atoms
(``full``: id mol type q x y z [ix iy iz]; ``atomic``: id type x y z),
Bonds, and Velocities sections.  Atom rows are sorted by id so array index ==
id-1 (the reference keeps arbitrary order plus a tag->index map; a fixed
order is the array-engine equivalent).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lidp_tpu_torch import native as native_mod


@dataclasses.dataclass
class DataFile:
    natoms: int
    ntypes: int
    box_lo: np.ndarray          # (3,)
    box_hi: np.ndarray          # (3,)
    x: np.ndarray               # (N,3)
    q: np.ndarray               # (N,)
    type: np.ndarray            # (N,) int, 1-based
    mol: np.ndarray             # (N,) int
    image: np.ndarray           # (N,3) int
    v: np.ndarray | None        # (N,3) or None
    mass: np.ndarray | None     # (ntypes+1,) or None (Masses section)
    bonds: np.ndarray           # (NB,2) int atom ids (1-based), empty ok
    tilt: np.ndarray = None     # (3,) xy xz yz triclinic tilts
    # atom_style sphere (read_data.cpp via AtomVecSphere::data_atom):
    # per-atom radius + rmass from diameter/density, angular velocities
    radius: np.ndarray = None   # (N,)
    rmass: np.ndarray = None    # (N,)
    omega: np.ndarray = None    # (N,3)
    bond_types: np.ndarray = None   # (NB,) int bond types (1-based)
    nbondtypes: int = 0
    angles: np.ndarray = None       # (NA,3) atom ids
    angle_types: np.ndarray = None
    dihedrals: np.ndarray = None    # (ND,4) atom ids
    dihedral_types: np.ndarray = None
    impropers: np.ndarray = None
    # fix cmap crossterm rows [type a1..a5] (read_data ... fix cmap
    # crossterm CMAP; FixCMAP::read_data_section fix_cmap.cpp:1065)
    crossterms: np.ndarray = None
    improper_types: np.ndarray = None
    # coeff sections embedded in the data file (read_data.cpp coeff blocks):
    # type -> [values...]
    pair_coeffs: dict = None
    bond_coeffs: dict = None
    angle_coeffs: dict = None
    dihedral_coeffs: dict = None
    improper_coeffs: dict = None


_HEADER_KEYS = (
    "atoms", "bonds", "angles", "dihedrals", "impropers",
    "crossterms",
    "atom types", "bond types", "angle types", "dihedral types",
    "improper types",
)

_SECTIONS = {
    "Masses", "Atoms", "Velocities", "Bonds", "Angles", "Dihedrals",
    "Impropers", "Pair Coeffs", "Bond Coeffs", "Angle Coeffs",
    "PairIJ Coeffs", "CMAP",
}


def _strip(line: str) -> str:
    i = line.find("#")
    if i >= 0:
        line = line[:i]
    return line.strip()


def read_data(path: str, atom_style: str = "full",
              native: bool = True) -> DataFile:
    with open(path) as fh:
        lines = fh.readlines()

    counts = {k: 0 for k in _HEADER_KEYS}
    box_lo = np.zeros(3)
    box_hi = np.zeros(3)
    tilt = np.zeros(3)

    # header: first line is a title; header ends at the first section keyword
    i = 1
    while i < len(lines):
        raw = lines[i]
        s = _strip(raw)
        if not s:
            i += 1
            continue
        first_words = s.split()
        section = None
        for name in _SECTIONS:
            if s == name or s.startswith(name + " "):
                section = name
        if section or (first_words and first_words[0] in _SECTIONS):
            break
        toks = s.split()
        matched = False
        for key in _HEADER_KEYS:
            kt = key.split()
            if toks[len(toks) - len(kt):] == kt:
                counts[key] = int(toks[0])
                matched = True
                break
        if not matched:
            if s.endswith("xlo xhi"):
                box_lo[0], box_hi[0] = float(toks[0]), float(toks[1])
            elif s.endswith("ylo yhi"):
                box_lo[1], box_hi[1] = float(toks[0]), float(toks[1])
            elif s.endswith("zlo zhi"):
                box_lo[2], box_hi[2] = float(toks[0]), float(toks[1])
            elif s.endswith("xy xz yz"):
                tilt = np.array([float(t) for t in toks[:3]])
        i += 1

    n = counts["atoms"]
    ntypes = counts["atom types"]
    x = np.zeros((n, 3))
    q = np.zeros(n)
    typ = np.zeros(n, np.int32)
    mol = np.zeros(n, np.int32)
    image = np.zeros((n, 3), np.int32)
    v = None
    mass = None
    radius = np.zeros(n) if atom_style == "sphere" else None
    rmass = np.zeros(n) if atom_style == "sphere" else None
    omega = np.zeros((n, 3)) if atom_style == "sphere" else None
    crossterms = None
    bonds = np.zeros((counts["bonds"], 2), np.int64)
    bond_types = np.zeros(counts["bonds"], np.int32)
    angles = np.zeros((counts["angles"], 3), np.int64)
    angle_types = np.zeros(counts["angles"], np.int32)
    dihedrals = np.zeros((counts["dihedrals"], 4), np.int64)
    dihedral_types = np.zeros(counts["dihedrals"], np.int32)
    impropers = np.zeros((counts["impropers"], 4), np.int64)
    improper_types = np.zeros(counts["impropers"], np.int32)
    coeff_sections: dict = {}

    def read_section(start: int, nrows: int):
        rows = []
        j = start
        while len(rows) < nrows and j < len(lines):
            s = _strip(lines[j])
            j += 1
            if not s:
                continue
            rows.append(s.split())
        return rows, j

    while i < len(lines):
        s = _strip(lines[i])
        if not s:
            i += 1
            continue
        name = s
        if name.startswith("Atoms") and native and n and (
                atom_style in native_mod.ATOM_LAYOUTS):
            cols, used = native_mod.parse_atoms(
                "".join(lines[i + 1:]).encode(), n, atom_style)
            x, q, typ, mol, image = (cols[k] for k in ("x", "q", "type",
                                                       "mol", "image"))
            i += 1 + used
        elif name.startswith("Atoms"):
            rows, i = read_section(i + 1, n)
            for r in rows:
                aid = int(r[0])
                k = aid - 1
                if atom_style == "full":
                    mol[k] = int(r[1])
                    typ[k] = int(r[2])
                    q[k] = float(r[3])
                    x[k] = [float(r[4]), float(r[5]), float(r[6])]
                    if len(r) >= 10:
                        image[k] = [int(r[7]), int(r[8]), int(r[9])]
                elif atom_style == "atomic":
                    typ[k] = int(r[1])
                    x[k] = [float(r[2]), float(r[3]), float(r[4])]
                    if len(r) >= 8:
                        image[k] = [int(r[5]), int(r[6]), int(r[7])]
                elif atom_style == "charge":
                    # id type q x y z [ix iy iz] (AtomVecCharge::data_atom)
                    typ[k] = int(r[1])
                    q[k] = float(r[2])
                    x[k] = [float(r[3]), float(r[4]), float(r[5])]
                    if len(r) >= 9:
                        image[k] = [int(r[6]), int(r[7]), int(r[8])]
                elif atom_style in ("bond", "angle", "molecular"):
                    # identical column layout: id mol type x y z
                    # (AtomVecBond/AtomVecAngle/AtomVecMolecular::data_atom)
                    mol[k] = int(r[1])
                    typ[k] = int(r[2])
                    x[k] = [float(r[3]), float(r[4]), float(r[5])]
                    if len(r) >= 9:
                        image[k] = [int(r[6]), int(r[7]), int(r[8])]
                elif atom_style == "sphere":
                    # id type diameter density x y z [ix iy iz]
                    # (AtomVecSphere::data_atom: radius = d/2; rmass =
                    # 4/3 pi r^3 * density for d > 0, else density = mass)
                    typ[k] = int(r[1])
                    d = float(r[2])
                    dens = float(r[3])
                    radius[k] = 0.5 * d
                    rmass[k] = (4.0 / 3.0 * np.pi * radius[k] ** 3 * dens
                                if d > 0.0 else dens)
                    x[k] = [float(r[4]), float(r[5]), float(r[6])]
                    if len(r) >= 10:
                        image[k] = [int(r[7]), int(r[8]), int(r[9])]
                else:
                    raise ValueError(f"unsupported atom_style {atom_style}")
        elif name.startswith("Velocities"):
            rows, i = read_section(i + 1, n)
            v = np.zeros((n, 3))
            for r in rows:
                v[int(r[0]) - 1] = [float(r[1]), float(r[2]), float(r[3])]
                if atom_style == "sphere" and len(r) >= 7:
                    # sphere style: vx vy vz wx wy wz
                    omega[int(r[0]) - 1] = [float(r[4]), float(r[5]),
                                            float(r[6])]
        elif name.startswith("Masses"):
            rows, i = read_section(i + 1, ntypes)
            mass = np.zeros(ntypes + 1)
            for r in rows:
                mass[int(r[0])] = float(r[1])
        elif name.startswith("Bonds"):
            rows, i = read_section(i + 1, counts["bonds"])
            for r in rows:
                k = int(r[0]) - 1
                bond_types[k] = int(r[1])
                bonds[k] = [int(r[2]), int(r[3])]
        elif name.startswith("Angles"):
            rows, i = read_section(i + 1, counts["angles"])
            for r in rows:
                k = int(r[0]) - 1
                angle_types[k] = int(r[1])
                angles[k] = [int(r[2]), int(r[3]), int(r[4])]
        elif name.startswith("Dihedrals"):
            rows, i = read_section(i + 1, counts["dihedrals"])
            for r in rows:
                k = int(r[0]) - 1
                dihedral_types[k] = int(r[1])
                dihedrals[k] = [int(r[2]), int(r[3]), int(r[4]), int(r[5])]
        elif name.startswith("Impropers"):
            rows, i = read_section(i + 1, counts["impropers"])
            for r in rows:
                k = int(r[0]) - 1
                improper_types[k] = int(r[1])
                impropers[k] = [int(r[2]), int(r[3]), int(r[4]), int(r[5])]
        elif name == "CMAP":
            rows, i = read_section(i + 1, counts["crossterms"])
            crossterms = np.zeros((len(rows), 6), np.int64)
            for r in rows:
                k = int(r[0]) - 1
                crossterms[k] = [int(v) for v in r[1:7]]
        elif name.endswith("Coeffs") and not name.startswith("PairIJ"):
            nrow = {"Pair Coeffs": ntypes,
                    "Bond Coeffs": counts.get("bond types", 0),
                    "Angle Coeffs": counts.get("angle types", 0),
                    "Dihedral Coeffs": counts.get("dihedral types", 0),
                    "Improper Coeffs": counts.get("improper types", 0)}[name]
            rows, i = read_section(i + 1, nrow)
            coeff_sections[name] = {
                int(r[0]): [float(v) for v in r[1:]] for r in rows}
        else:
            # skip unknown section: its row count is unknown; consume until
            # the next recognized section header (coeff sections etc.)
            i += 1
            while i < len(lines):
                s2 = _strip(lines[i])
                if s2 and any(s2 == k or s2.startswith(k + " ") for k in _SECTIONS):
                    break
                i += 1
            continue

    return DataFile(
        natoms=n, ntypes=ntypes, box_lo=box_lo, box_hi=box_hi, tilt=tilt,
        radius=radius, rmass=rmass, omega=omega,
        x=x, q=q, type=typ, mol=mol, image=image, v=v, mass=mass,
        bonds=bonds, bond_types=bond_types, nbondtypes=counts["bond types"],
        angles=angles, angle_types=angle_types,
        dihedrals=dihedrals, dihedral_types=dihedral_types,
        impropers=impropers, improper_types=improper_types,
        crossterms=crossterms,
        pair_coeffs=coeff_sections.get("Pair Coeffs"),
        bond_coeffs=coeff_sections.get("Bond Coeffs"),
        angle_coeffs=coeff_sections.get("Angle Coeffs"),
        dihedral_coeffs=coeff_sections.get("Dihedral Coeffs"),
        improper_coeffs=coeff_sections.get("Improper Coeffs"),
    )
