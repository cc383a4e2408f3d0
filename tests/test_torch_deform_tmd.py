"""fix deform (orthogonal boxes) with compute temp/deform, fix tmd and
fix adapt of lidp_tpu_torch against the JAX package's, float64 on the
CPU, both packages' LammpsScript on the same scripts, each run once in a
module-scoped fixture:

  * deform: x/y/z scale with remap x on a cold crystal (test_deform's
    affine and energy checks on the port: the box is the scaled one, the
    atoms stay on the scaled lattice, and a `run 0` after `unfix` gives
    the energy of a fresh evaluation), final/delta/vel with remap none
    over two runs (each run's window and targets anew), and x erate with
    remap v on the cell grid (DENSE_PATH_MAX_ATOMS mocked in both
    packages), where atoms that cross the moving faces take their
    velocity; compute temp/deform in the rows.  test_deform's tilt case
    and test_sllod's goldens need a triclinic box (ROADMAP queue 1 item
    6.4): a tilt keyword raises;
  * tmd: test_controller_molecule's golden rows and statistics file (the
    port's file against JAX's, and both against the reference's rows at
    that test's bars);
  * adapt: a soft-sphere lattice whose prefactor ramps over two runs
    (examples/micelle's data is not in the repository).

Rows within rel 1e-8 of max(1, |JAX's value|), the final x and v within
1e-8 of their largest entry.
"""

from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from lidp_tpu import sim as jsim  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch.forcefield import compute_forces  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.parallel import fast_polar as tfast  # noqa: E402
from tests import test_controller_molecule as tcm  # noqa: E402

ROWS = 1e-8

LATTICE = """\
units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 {n} 0 {n} 0 {n}
create_box 1 box
create_atoms 1 box
mass 1 1.0
"""
LJ = "pair_style lj/cut 2.5\npair_coeff 1 1 1.0 1.0 2.5\n"

TMD_HEAD = """\
units lj
atom_style atomic
atom_modify map array
boundary p p p
lattice fcc 0.8442
region box block 0 3 0 3 0 3
create_box 1 box
create_atoms 1 box
mass 1 1.0
velocity all create 0.1 87287 loop geom
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0
neighbor 0.3 bin
fix 1 all nve
"""

CASES = {
    # test_deform_scale_affine's cold crystal (100 steps there)
    "scale": LATTICE.format(n=3) + LJ + (
        "fix 1 all nve\nfix 2 all deform 1 x scale 1.2 y scale 1.2 "
        "z scale 1.2 remap x units box\ncompute td all temp/deform\n"
        "thermo 20\nthermo_style custom step temp c_td pe press vol lx\n"
        "run 100\n"),
    # test_deform_scale_energy_consistent
    "scale_energy": LATTICE.format(n=3) + LJ + (
        "fix 1 all nve\nfix 2 all deform 1 x scale 1.1 remap x units box\n"
        "thermo 50\nrun 100\nunfix 2\nrun 0\n"),
    "final_delta_vel": LATTICE.format(n=4) + LJ + (
        "velocity all create 1.44 87287 loop geom\nfix 1 all nve\n"
        "fix 2 all deform 1 x final 0.0 7.0 y delta -0.1 0.2 z vel 0.5 "
        "remap none\ncompute td all temp/deform\nthermo 5\n"
        "thermo_style custom step temp c_td pe press vol xlo xhi ylo zhi\n"
        "run 10\nrun 10\n"),
    "erate_remap_v": LATTICE.format(n=6) + LJ + (
        "velocity all create 0.8 87287 loop geom\nfix 1 all nve\n"
        "fix 2 all deform 1 x erate 0.05 remap v\n"
        "compute td all temp/deform\nthermo 10\n"
        "thermo_style custom step temp c_td pe press lx\nrun 60\n"),
    "tmd": TMD_HEAD + ("fix steer all tmd 0.05 target.tmd 0\nthermo 5\n"
                       "thermo_style custom step temp pe press\nrun 20\n"),
    "tmd_stats": TMD_HEAD + (
        "fix steer all tmd 0.05 target.tmd 5 tmd.out\nthermo 5\n"
        "thermo_style custom step temp pe press\nrun 20\n"),
    "adapt": LATTICE.format(n=4) + (
        "velocity all create 1.0 4928 loop geom\n"
        "pair_style soft 1.12246\npair_coeff * * 0.0\n"
        "variable prefactor equal ramp(0.0,30.0)\nfix 1 all nve\n"
        "fix 2 all adapt 1 pair soft a * * v_prefactor\nthermo 5\n"
        "thermo_style custom step temp pe press v_prefactor\n"
        "run 20\nrun 10\n"),
}
# the cases on the cell grid, and the cap that puts them there
CELLS = {"erate_remap_v": 500}


def _target(d):
    """test_fix_tmd_golden's target: the 108-site lattice jittered from
    TMD_TARGET_SEED."""
    a = (4 / 0.8442) ** (1 / 3)
    basis = [(0, 0, 0), (0.5, 0.5, 0), (0.5, 0, 0.5), (0, 0.5, 0.5)]
    pts = np.array([((i + b[0]) * a, (j + b[1]) * a, (k + b[2]) * a)
                    for k in range(3) for j in range(3) for i in range(3)
                    for b in basis])
    rng = np.random.RandomState(tcm.TMD_TARGET_SEED)
    tgt = pts + 0.35 * rng.uniform(-1, 1, pts.shape)
    with open(d / "target.tmd", "w") as f:
        for i, p in enumerate(tgt):
            f.write(f"{i+1} {p[0]:.10f} {p[1]:.10f} {p[2]:.10f}\n")


def _script(pkg, directory, text):
    path = Path(directory) / f"in.{pkg}"
    path.write_text(text)
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64, log=lambda line: None)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                                 log=lambda line: None)
    s.file(str(path))
    return s


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's (JAX script, port script, the two run directories),
    run once; each package in a directory of its own (tmd's file)."""
    out = {}
    for name, text in CASES.items():
        dirs = [tmp_path_factory.mktemp(f"{name}_{pkg}")
                for pkg in ("jax", "torch")]
        for d in dirs:
            _target(d)
        cap = CELLS.get(name, jsim.DENSE_PATH_MAX_ATOMS)
        with mock.patch.object(jsim, "DENSE_PATH_MAX_ATOMS", cap), \
                mock.patch.object(tfast, "DENSE_PATH_MAX_ATOMS", cap):
            out[name] = (_script("jax", dirs[0], text),
                         _script("torch", dirs[1], text), dirs)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_rows_match_jax(runs, name):
    js, ts, _ = runs[name]
    assert len(ts.thermo_rows) == len(js.thermo_rows) > 1
    for rj, rt in zip(js.thermo_rows, ts.thermo_rows):
        for c, v in rj.items():
            if c in ("atoms", "bonds", "angles", "dihedrals", "impropers") \
                    or not np.isfinite(float(v)):
                continue
            assert abs(float(rt[c]) - float(v)) <= ROWS * max(
                1.0, abs(float(v))), (name, rj["step"], c, rt[c], v)
    n = ts._sim.natoms
    for a in ("x", "v"):
        xj = np.asarray(getattr(js._sim.sys, a))[:n]
        xt = getattr(ts._sim.sys, a)[:n].numpy()
        assert np.abs(xt - xj).max() <= ROWS * max(1.0, np.abs(xj).max())


def test_deform_scale_affine(runs):
    """test_deform_scale_affine on the port: the box is 1.2 times the
    lattice's and the atoms sit on the scaled lattice."""
    sim = runs["scale"][1]._sim
    L = sim.sys.box.lengths.numpy()
    a0 = (4 / 0.8442) ** (1 / 3) * 3
    assert np.allclose(L, 1.2 * a0, rtol=1e-10), L
    frac = (sim.sys.x.numpy() - sim.sys.box.lo.numpy()) / L
    cell = frac * 6
    assert np.abs(cell - np.round(cell)).max() < 1e-6


def test_deform_scale_energy_consistent(runs):
    """test_deform_scale_energy_consistent on the port: the row of the
    `run 0` after the deforming run is a fresh evaluation's energy."""
    ts = runs["scale_energy"][1]
    sim = ts._sim
    res = compute_forces(sim.sys, sim.runner.ff)
    assert abs(float(res.epair) / ts.x.shape[0]
               - ts.thermo_rows[-1]["epair"]) < 1e-9


def test_deform_remap_v_crossings(runs):
    """The remap-v run is on the cell grid and atoms crossed the moving x
    faces (their image flags changed), so the face velocity was applied;
    temp/deform's bias is the streaming profile of the run's rate."""
    ts = runs["erate_remap_v"][1]
    sim = ts._sim
    assert sim.nlist is not None
    assert int(sim.sys.image[:, 0].abs().max()) > 0
    assert sim.h_rate[0] > 0 and sim.h_rate[1] == sim.h_rate[2] == 0.0
    row = ts.thermo_rows[-1]
    assert row["c_td"] != row["temp"]


def test_fix_tmd_golden(runs):
    """test_fix_tmd_golden's rows at its bars, through step 15."""
    rows = {int(r["step"]): r for r in runs["tmd"][1].thermo_rows}
    for step, t, pe, pr in tcm.TMD_GOLDEN:
        r = rows[step]
        assert float(r["temp"]) == pytest.approx(t, rel=1e-10), step
        assert float(r["pe"]) == pytest.approx(pe, rel=1e-10), step
        assert float(r["press"]) == pytest.approx(pr, rel=1e-9), step
    assert float(rows[20]["pe"]) == pytest.approx(28.4489095941, rel=1e-3)


def _tmd_rows(d):
    lines = (d / "tmd.out").read_text().splitlines()
    assert lines[0].startswith("# Step rho_target rho_old gamma_back")
    return {int(ln.split()[0]): [float(v) for v in ln.split()[1:]]
            for ln in lines[1:]}


def test_fix_tmd_stats_file(runs):
    """The statistics file: the port's rows equal JAX's (both print %g)
    and meet test_fix_tmd_stats_file_golden's reference rows at its
    bars."""
    _, _, (dj, dt) = runs["tmd_stats"]
    got, ref = _tmd_rows(dt), _tmd_rows(dj)
    assert sorted(got) == sorted(ref) == [5, 10, 15, 20]
    for step in got:
        np.testing.assert_allclose(got[step], ref[step], rtol=1e-5,
                                   atol=1e-6)
    for step, gold in tcm.TMD_STAT_GOLDEN.items():
        rel = 1e-4 if step < 20 else 2e-2
        for v, r in zip(got[step], gold):
            assert v == pytest.approx(r, rel=rel, abs=1e-6), (step, gold)


def test_adapt_ramps_prefactor(runs):
    """The ramp variable's column restarts with each run, and the soft
    potential's energy grows from zero with it."""
    rows = runs["adapt"][1].thermo_rows
    assert [r["v_prefactor"] for r in rows] == [0.0, 7.5, 15.0, 22.5, 30.0,
                                                0.0, 15.0, 30.0]
    assert rows[0]["pe"] == 0.0 < rows[1]["pe"] < rows[4]["pe"]


REFUSALS = {
    "tilt": "fix 2 all deform 1 xy final 0.5",
    "tilt erate": "fix 2 all deform 1 x scale 1.1 xz erate 0.01",
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_tilt_refused(tmp_path, name):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6.4"):
        _script("torch", tmp_path, LATTICE.format(n=3) + LJ
                + "fix 1 all nve\n" + REFUSALS[name] + "\nrun 0\n")
