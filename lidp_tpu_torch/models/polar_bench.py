"""Polarizable panel-engine workload (lidp_tpu/models/polar_bench.py).

The JAX package's polar benchmark replicates the MOF5+Methane example,
whose files this port does not read; `build_synthetic` builds a fluid of
3-site polarizable molecules instead (the molecule, charges, types,
polarizabilities and LJ tables of `__graft_entry__._tiny_polar_system` /
`entry()`), on a jittered cubic lattice with O-H bonds so the special lists
and the pair kernel's `sp` operand are on the path.  The default size,
15^3 molecules = 10,125 atoms (npad 12,288), is the size of the JAX
package's 10k polar benchmark.

Under velocity Verlet with free atoms it is a cost workload, like the JAX
benchmark with its free sorbates: bond forces are absent, so it runs a few
dozen steps, not a trajectory.

    bench = build_synthetic()                  # on the GPU, float32
    f, energies = setup_forces(bench)
    f, per_step = run(bench, 20)               # 20 velocity-Verlet steps

`build_rigid` makes each molecule a rigid body (`fix rigid/nve molecule`,
the reference examples' integrator), so the same fluid runs a real
trajectory, through FastPolarRunner (parallel/fast_polar.py) as the JAX
script engine runs it:

    bench = build_rigid()                      # on the GPU, float32
    row0 = setup_rigid(bench)                  # thermo row of step 0
    rows = run_rigid(bench, 20)                # one thermo row per step

The host-driven evaluation (parallel/fast_polar.py HostPolarForces) runs
the same step phase by phase; in float64 at polar_precision 1e-11 with the
mixed-precision dipole solve it is the reference's own regime:

    bench = build_synthetic(dtype=torch.float64, precision=1e-11)
    f, energies = host_setup_forces(bench, mixed=True)
    f, energies = host_cg_step(bench, mixed=True)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidp_tpu_torch import resolve_device, units
from lidp_tpu_torch.box import Box
from lidp_tpu_torch.forcefield import ForceField
from lidp_tpu_torch.integrate import rigid
from lidp_tpu_torch.integrate.driver import Runner, rigid_nve_integrator
from lidp_tpu_torch.ops import polarization as pol_ops
from lidp_tpu_torch.ops.ewald import EwaldParams, setup_ewald_disp
from lidp_tpu_torch.ops.pair import make_pair_params
from lidp_tpu_torch.parallel.fast_polar import (FastPolarRunner,
                                                HostPolarForces,
                                                aligned_npad)
from lidp_tpu_torch.parallel.shard import PolarStep, build_sharded_polar_step
from lidp_tpu_torch.state import System, make_system
from lidp_tpu_torch.thermo import ThermoParams, thermo_row
from lidp_tpu_torch.topology import special_lists

DT = 0.5                 # fs
CUT_COUL = 6.5
EWALD_ACCURACY = 1e-4
OH = 0.7                 # O-H distance, Angstrom


@dataclasses.dataclass
class PolarBench:
    step: PolarStep
    arrays: dict
    natoms: int
    npad: int
    # host-driven phase mode (make_host_phases, HostPolarForces)
    phases: dict | None = None
    settings: object = None
    dt: float = 0.0
    ftm2v: float = 1.0
    hpf: HostPolarForces | None = None


def synthetic_system(n_side: int = 15, spacing: float = 4.0, seed: int = 0):
    """numpy inputs of the synthetic fluid: n_side^3 linear H-O-H
    molecules with random orientations, centres on a cubic lattice jittered
    by +-0.2 A, velocities N(0, 0.005 A/fs), all from RandomState(seed).
    Returns a dict with x v q type mol alpha mass (n,..), bonds (nb,2)
    1-based, L (3,), and the LJ tables eps sig cut (3,3) + cut_coul."""
    rng = np.random.RandomState(seed)
    nm = n_side**3
    g = (np.arange(n_side) + 0.5) * spacing
    centers = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    centers = centers + rng.uniform(-0.2, 0.2, size=(nm, 3))
    u = rng.normal(size=(nm, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    x = np.stack([centers, centers + OH * u, centers - OH * u],
                 axis=1).reshape(-1, 3)
    n = 3 * nm
    first = 3 * np.arange(nm) + 1                  # 1-based O ids
    bonds = np.stack([np.repeat(first, 2),
                      np.stack([first + 1, first + 2], 1).reshape(-1)], 1)
    eps = np.zeros((3, 3))
    sig = np.zeros((3, 3))
    cut = np.zeros((3, 3))
    eps[1:, 1:] = [[0.1, 0.05], [0.05, 0.03]]
    sig[1:, 1:] = [[3.0, 2.7], [2.7, 2.5]]
    cut[1:, 1:] = 6.0
    return dict(
        x=x, v=rng.normal(scale=0.005, size=(n, 3)),
        q=np.tile([-0.8, 0.4, 0.4], nm),
        type=np.tile([1, 2, 2], nm).astype(np.int64),
        mol=np.repeat(np.arange(1, nm + 1), 3).astype(np.int64),
        alpha=np.tile([1.1, 0.4, 0.4], nm),
        mass=np.tile([15.9994, 1.008, 1.008], nm),
        bonds=bonds.astype(np.int64),
        L=np.full(3, n_side * spacing),
        eps=eps, sig=sig, cut=cut, cut_coul=CUT_COUL)


def synthetic_forcefield(sysd: dict, dtype=torch.float32, device="cuda",
                         precision: float = 1e-6) -> ForceField:
    """The port's own force field for a synthetic_system dict: lj/cut +
    coul/long, ewald/disp at accuracy 1e-4, CG SCF at `precision` with
    exponential damping and warm start."""
    u = units.REAL
    n = sysd["x"].shape[0]
    es = setup_ewald_disp(accuracy_rel=EWALD_ACCURACY, qqrd2e=u.qqr2e,
                          q=sysd["q"], natoms=n, cutoff=sysd["cut_coul"],
                          box_lengths=sysd["L"])
    pair = make_pair_params(sysd["eps"], sysd["sig"], sysd["cut"],
                            cut_coul=sysd["cut_coul"], qqrd2e=u.qqr2e,
                            g_ewald=es.g_ewald, dtype=dtype, device=device)
    s = pol_ops.PolarizationSettings(
        iterations_max=50, damping_type=pol_ops.DAMPING_EXPONENTIAL,
        polar_precision=precision, use_previous=True)
    return ForceField(pair=pair,
                      ewald=EwaldParams.from_setup(es, u.qqr2e, dtype=dtype,
                                                   device=device),
                      polar=s, qqrd2e=u.qqr2e)


def build_synthetic(n_side: int = 15, spacing: float = 4.0, seed: int = 0,
                    dtype=torch.float32, device="cuda", *,
                    ff: ForceField | None = None,
                    panel: str = "kernel", precision: float = 1e-6,
                    host_strips: int = 1) -> PolarBench:
    """The synthetic fluid on `device` (raises without CUDA unless given
    device="cpu").  ff: a force field to use instead of
    synthetic_forcefield's (e.g. tables carried across by convert.py);
    panel: "kernel" (the CUDA kernels on a GPU) or "scan" (plain path);
    precision: the SCF's polar_precision (of synthetic_forcefield's
    settings); host_strips: row strips of the host phases kept in
    `bench.phases`."""
    device = resolve_device(device)
    sysd = synthetic_system(n_side, spacing, seed)
    n = sysd["x"].shape[0]
    if ff is None:
        ff = synthetic_forcefield(sysd, dtype, device, precision)
    u = units.REAL
    step = build_sharded_polar_step(None, ff, ff.polar, n=n, dt=DT,
                                    ftm2v=u.ftm2v, dtype=dtype, panel=panel,
                                    device=device)
    step.bind_box(sysd["L"])
    step.bind_special(*special_lists(n, sysd["bonds"]))
    npad = step.npad

    def pad(a, fill=0.0, dt=dtype):
        a = np.asarray(a)
        out = np.full((npad,) + a.shape[1:], fill, a.dtype)
        out[:n] = a
        return torch.as_tensor(out, dtype=dt, device=device)

    arrays = dict(
        x=pad(sysd["x"]), v=pad(sysd["v"]), q=pad(sysd["q"]),
        type=pad(sysd["type"], 0, torch.int64),
        mol=pad(sysd["mol"], 0, torch.int64), alpha=pad(sysd["alpha"]),
        mu=pad(np.zeros((n, 3))), mass=pad(sysd["mass"], 1.0),
        mask=pad(np.ones(n, bool), False, torch.bool))
    return PolarBench(step=step, arrays=arrays, natoms=n, npad=npad,
                      phases=step.make_host_phases(strips=host_strips),
                      settings=ff.polar, dt=DT, ftm2v=u.ftm2v)


def setup_forces(bench: PolarBench):
    """Initial force + SCF evaluation; returns (f, energies)."""
    a = bench.arrays
    f, mu, energies = bench.step.init(a["x"], a["q"], a["type"], a["mol"],
                                      a["alpha"], a["mu"], a["mask"])
    a["mu"], a["f"] = mu, f
    return f, energies


def run_step(bench: PolarBench):
    """One velocity-Verlet step (the initial forces first if needed)."""
    a = bench.arrays
    if "f" not in a:
        setup_forces(bench)
    x, v, mu, f, energies = bench.step(
        a["x"], a["v"], a["f"], a["q"], a["type"], a["mol"], a["alpha"],
        a["mu"], a["mass"], a["mask"])
    a["x"], a["v"], a["mu"], a["f"] = x, v, mu, f
    return f, energies


def _host_forces(bench: PolarBench, mixed: bool) -> HostPolarForces:
    """The bench's HostPolarForces, built once per `mixed`."""
    if bench.hpf is None or bench.hpf.mixed != mixed:
        bench.hpf = HostPolarForces(bench.phases, bench.settings,
                                    bench.natoms, mixed=mixed)
    return bench.hpf


def host_setup_forces(bench: PolarBench, mixed: bool = False):
    """setup_forces through the host-driven evaluation; returns (f,
    energies), energies with scf_converged."""
    a = bench.arrays
    f, mu, energies = _host_forces(bench, mixed)(
        a["x"], a["q"], a["type"], a["mol"], a["alpha"], a["mu"], a["mask"])
    a["mu"], a["f"] = mu, f
    return f, energies


def host_cg_step(bench: PolarBench, zero_init: bool = False,
                 mixed: bool = False):
    """One velocity-Verlet step with the force + SCF evaluation driven from
    the host phase by phase (HostPolarForces): the same math as run_step.
    Without initial forces the first kick uses f = 0 (zero_init is kept for
    the JAX signature; it has nothing to skip here).

    mixed=True: mixed-precision iterative refinement for the float64 /
    1e-11 regime.  B = I + sqrt(a) T sqrt(a) is symmetric positive definite
    and strongly diagonally dominant, so refinement converges in 2-3 outer
    passes: the O(N^2) matvecs run in float32 inside an inner CG and only
    the outer residuals r = b - B y in float64.  The reference's per-sweep
    dipole-change criterion (change/(3N) <= precision^2) is measured on the
    refinement correction itself.

    Returns (f, energies) like run_step, energies with scf_converged."""
    a = bench.arrays
    if "f" not in a:
        a["f"] = torch.zeros_like(a["x"])
    hpf = _host_forces(bench, mixed)
    dtf = 0.5 * bench.dt * bench.ftm2v
    mass, mask = a["mass"], a["mask"]
    pos = mass > 0
    minv = torch.where(pos, 1.0 / torch.where(pos, mass, 1.0), 0.0)
    kick = (dtf * minv)[:, None]
    v = torch.where(mask[:, None], a["v"] + kick * a["f"], 0.0)
    x = a["x"] + bench.dt * v
    f, mu, en = hpf(x, a["q"], a["type"], a["mol"], a["alpha"], a["mu"],
                    mask)
    v = torch.where(mask[:, None], v + kick * f, 0.0)
    a["x"], a["v"], a["mu"], a["f"] = x, v, mu, f
    return f, en


# dipole history extrapolation coefficients for the SCF initial guess
# (Lagrange extrapolation through the last p converged dipole sets; each
# row sums to 1 so a replicated cold history reduces to plain warm start).
# CG still iterates to the unchanged convergence criterion.
_PREDICT_COEF = {
    1: (1.0,),
    2: (2.0, -1.0),
    3: (3.0, -3.0, 1.0),
    4: (4.0, -6.0, 4.0, -1.0),
}


def run(bench: PolarBench, k: int, predict: int = 1):
    """k MD steps with the dipole-history predictor of order `predict`
    (1 = plain warm start, the reference's use_previous).  The port of
    make_scan_runner: a Python loop in place of the lax.scan.  Returns
    (f, [energies of each step])."""
    coef = _PREDICT_COEF[predict]
    a = bench.arrays
    if "f" not in a:
        a["f"] = torch.zeros_like(a["x"])
    x, v, f = a["x"], a["v"], a["f"]
    hist = [a["mu"]] * len(coef)
    per_step = []
    for _ in range(k):
        guess = sum(c * h for c, h in zip(coef, hist))
        x, v, mu2, f, en = bench.step(x, v, f, a["q"], a["type"], a["mol"],
                                      a["alpha"], guess, a["mass"],
                                      a["mask"])
        hist = [mu2] + hist[:-1]
        per_step.append(en)
    a["x"], a["v"], a["mu"], a["f"] = x, v, hist[0], f
    return f, per_step


# -------------------------- rigid molecules --------------------------------


@dataclasses.dataclass
class RigidBench:
    runner: FastPolarRunner
    system: System          # the state before setup
    thermo: ThermoParams    # dof = 3N - 3 - setup.dof_removed
    setup: rigid.RigidSetup
    natoms: int
    npad: int
    # (sys, res, istate) after setup_rigid / run_rigid
    state: tuple | None = None


def build_rigid(n_side: int = 15, spacing: float = 4.0, seed: int = 0,
                dtype=torch.float32, device="cuda", *,
                ff: ForceField | None = None, panel: str = "kernel",
                precision: float = 1e-6) -> RigidBench:
    """The synthetic fluid with each molecule a rigid body (fix rigid/nve
    molecule): a FastPolarRunner around Runner(ff, rigid_nve_integrator),
    its System (padded to the panel alignment; the positions of the body
    atoms stay unwrapped from here on) and the thermo parameters.  The
    molecules are linear, so each body has one zero principal moment and
    5 degrees of freedom.  The mode is FastPolarRunner's (fused, or
    LIDP_FAST_POLAR_MODE=host).  ff, panel and precision as in
    build_synthetic."""
    device = resolve_device(device)
    sysd = synthetic_system(n_side, spacing, seed)
    n = sysd["x"].shape[0]
    if ff is None:
        ff = synthetic_forcefield(sysd, dtype, device, precision)
    u = units.REAL
    npad = aligned_npad(n)

    def pad(a, fill=0.0):
        a = np.asarray(a)
        out = np.full((npad,) + a.shape[1:], fill, a.dtype)
        out[:n] = a
        return out

    x, mass, mol = pad(sysd["x"]), pad(sysd["mass"], 1.0), pad(sysd["mol"], 0)
    mask = pad(np.ones(n, bool), False)
    setup = rigid.setup_bodies(x, mass, mol, mask)
    params = rigid.make_rigid_params(setup, DT, u.ftm2v, mass_atom=mass,
                                     dtype=dtype, device=device)
    inner = Runner(ff, rigid_nve_integrator(params, params.mass_atom))
    box = Box.create(np.zeros(3), sysd["L"], dtype=dtype, device=device)
    system = make_system(x, box=box, v=pad(sysd["v"]), q=pad(sysd["q"]),
                         type=pad(sysd["type"], 0), mol=mol,
                         alpha=pad(sysd["alpha"]), mask=mask, dtype=dtype,
                         device=device)
    runner = FastPolarRunner(
        inner, ff=ff, pol=ff.polar, n=n, npad=npad, dt=DT, ftm2v=u.ftm2v,
        box_lo=np.zeros(3), box_lengths=sysd["L"],
        sp_lists=special_lists(n, sysd["bonds"]), dtype=dtype,
        device=device, panel=panel)
    thermo = ThermoParams.create(mass, 3 * n - 3 - setup.dof_removed, u,
                                 norm=False, natoms=n, dtype=dtype,
                                 device=device)
    return RigidBench(runner=runner, system=system, thermo=thermo,
                      setup=setup, natoms=n, npad=npad)


def _row(bench, sys, res, istate) -> dict:
    """The thermo row, the constraint virial of rigid/nve in the pressure,
    and the step's scf_iters."""
    row = thermo_row(sys, res, bench.thermo,
                     extra_virial=getattr(istate, "virial", None))
    return dict(row, scf_iters=int(res.scf_iters))


def setup_rigid(bench: RigidBench) -> dict:
    """Initial forces and the integrator's setup (set_v): the thermo row of
    step 0."""
    sys, res, _, istate = bench.runner.setup(bench.system)
    bench.state = (sys, res, istate)
    return _row(bench, *bench.state)


def run_rigid(bench: RigidBench, k: int) -> list:
    """k steps (setup first if needed); the thermo row of each, with epol
    (and scf_iters).  The rows are read from the device after the k
    steps."""
    if bench.state is None:
        setup_rigid(bench)
    sys, res, istate = bench.state
    snaps = []
    for _ in range(k):
        sys, res, _, istate = bench.runner.run(sys, res, None, istate, 1)
        snaps.append((sys, res, istate))
    bench.state = (sys, res, istate)
    return [_row(bench, *s) for s in snaps]
