"""Unit systems.

Constant values reproduce LAMMPS ``Update::set_units`` (reference
src/update.cpp:122-260) exactly; thermo parity to 1e-8 depends on them.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class Units:
    name: str
    boltz: float        # Boltzmann constant (energy/degree-K)
    hplanck: float      # Planck's constant
    mvv2e: float        # mass * velocity^2 -> energy
    ftm2v: float        # force/mass -> velocity
    mv2d: float         # mass/volume -> density
    nktv2p: float       # N kT / volume -> pressure
    qqr2e: float        # q^2 / r -> energy
    qe2f: float         # q * E field -> force
    qelectron: float    # electron charge in these units
    angstrom: float     # 1 angstrom in distance units
    femtosecond: float  # 1 fs in time units
    dt: float           # default timestep
    skin: float         # default neighbor skin


LJ = Units(
    name="lj",
    boltz=1.0, hplanck=1.0, mvv2e=1.0, ftm2v=1.0, mv2d=1.0, nktv2p=1.0,
    qqr2e=1.0, qe2f=1.0, qelectron=1.0, angstrom=1.0, femtosecond=1.0,
    dt=0.005, skin=0.3,
)

REAL = Units(
    name="real",
    boltz=0.0019872067,
    hplanck=95.306976368,
    mvv2e=48.88821291 * 48.88821291,
    ftm2v=1.0 / 48.88821291 / 48.88821291,
    mv2d=1.0 / 0.602214129,
    nktv2p=68568.415,
    qqr2e=332.06371,
    qe2f=23.060549,
    qelectron=1.0,
    angstrom=1.0,
    femtosecond=1.0,
    dt=1.0,
    skin=2.0,
)

METAL = Units(
    name="metal",
    boltz=8.617343e-5,
    hplanck=4.135667403e-3,
    mvv2e=1.0364269e-4,
    ftm2v=1.0 / 1.0364269e-4,
    mv2d=1.0 / 0.602214129,
    nktv2p=1.6021765e6,
    qqr2e=14.399645,
    qe2f=1.0,
    qelectron=1.0,
    angstrom=1.0,
    femtosecond=1.0e-3,
    dt=0.001,
    skin=2.0,
)

SI = Units(
    name="si",
    boltz=1.3806504e-23, hplanck=6.62606896e-34, mvv2e=1.0, ftm2v=1.0,
    mv2d=1.0, nktv2p=1.0, qqr2e=8.9876e9, qe2f=1.0, qelectron=1.6021765e-19,
    angstrom=1.0e-10, femtosecond=1.0e-15, dt=1.0e-8, skin=0.001,
)

CGS = Units(
    name="cgs",
    boltz=1.3806504e-16, hplanck=6.62606896e-27, mvv2e=1.0, ftm2v=1.0,
    mv2d=1.0, nktv2p=1.0, qqr2e=1.0, qe2f=1.0, qelectron=4.8032044e-10,
    angstrom=1.0e-8, femtosecond=1.0e-15, dt=1.0e-8, skin=0.1,
)

MICRO = Units(
    name="micro",
    boltz=1.3806504e-8, hplanck=6.62606896e-13, mvv2e=1.0, ftm2v=1.0,
    mv2d=1.0, nktv2p=1.0, qqr2e=8.987556e6, qe2f=1.0,
    qelectron=1.6021765e-19, angstrom=1.0e-4, femtosecond=1.0e-9,
    dt=2.0, skin=0.1,
)

NANO = Units(
    name="nano",
    boltz=0.013806504, hplanck=6.62606896e-4, mvv2e=1.0, ftm2v=1.0,
    mv2d=1.0, nktv2p=1.0, qqr2e=230.7078669, qe2f=1.0, qelectron=1.0,
    angstrom=1.0e-1, femtosecond=1.0e-6, dt=0.00045, skin=0.1,
)

BY_NAME = {u.name: u for u in (LJ, REAL, METAL, SI, CGS, MICRO, NANO)}


def get(name: str) -> Units:
    try:
        return BY_NAME[name]
    except KeyError:
        raise ValueError(f"unsupported unit style: {name!r}") from None
