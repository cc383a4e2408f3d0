"""The system-setup commands of lidp_tpu_torch (io/commands.py,
io/script.py): molecule with create_atoms ... mol and create_atoms
random, create_box's topology keywords, create_bonds and delete_bonds,
velocity scale and zero angular, and atom- and world-style variables,
against the JAX package's LammpsScript on the same scripts, float64 on
the CPU, and against the rebuilt reference's rows that the JAX tests hold
(test_molecule_create_atoms_golden's MOL_GOLDEN, test_create_delete_
bonds_golden's BONDS_GOLDEN, imported):

  * the water template on lattice sc with its RanMars rotations, bit for
    bit with JAX's sites, then the golden run; random sites with and
    without a template and a region; a charged water box under PPPM with
    dielectric 2, velocity scale and delete_bonds (chip_smoke.py path
    BK's script at 64 molecules);
  * create_bonds many on the fcc melt (the golden rows, the bonds in
    JAX's order) and the single/* styles, delete_bonds' styles and undo,
    remove and any;
  * velocity scale, zero angular and zero linear: JAX's velocities;
  * atom-style formulas (atom vectors, random() on the atom stream, v_
    references), their consumers (balance weight var, the library's
    extract_variable), world-style values;
  * `python -m lidp_tpu_torch -in` on these commands;
  * create_bonds single/improper, which the JAX package lacks, raises.

Each script runs once per package in a module-scoped fixture; rows agree
at rel 1e-8 of max(1, |JAX's value|).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time, as the port's other parity files
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from tests import test_controller_molecule as cm  # noqa: E402
from tests import test_misc_commands2 as m2  # noqa: E402

ROWS = 1e-8
REPO = Path(__file__).resolve().parent.parent

MOLECULE = """units lj
atom_style full
boundary p p p
lattice sc 0.05
region box block 0 3 0 3 0 3
create_box 2 box bond/types 1 angle/types 1 extra/bond/per/atom 4
molecule wat wat.mol
create_atoms 0 box mol wat 4523
mass 1 15.0
mass 2 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 0.2 1.5
pair_coeff 2 2 0.05 0.8
bond_style harmonic
bond_coeff 1 60.0 0.9
angle_style harmonic
angle_coeff 1 30.0 104.0
special_bonds lj/coul 0.0 0.0 0.5
fix 1 all nve
thermo 2
thermo_style custom step temp pe ebond eangle press atoms
run 4
"""

RANDOM = """units lj
atom_style full
boundary p p p
region box block 0 12 0 12 0 12
region inner sphere 6 6 6 4 units box
create_box 3 box bond/types 1 angle/types 1 extra/bond/per/atom 4 \
extra/special/per/atom 6
molecule wat wat.mol
create_atoms 0 random 20 777 NULL mol wat 991
create_atoms 3 random 15 4242 inner
create_atoms 3 single 1.0 1.0 1.0 units box
mass * 1.0
pair_style lj/cut 1.5
pair_coeff * * 0.01 0.5
bond_style harmonic
bond_coeff 1 60.0 0.9
angle_style harmonic
angle_coeff 1 30.0 104.0
thermo_style custom step pe ebond eangle press atoms
run 0
"""

# chip_smoke.py path BK's script (water_script) at 4^3 molecules
WATER = chip_smoke.water_script(4)

BONDS = m2.MELT_HEAD.replace("atom_style atomic", "atom_style bond").replace(
    "0 4 0 4 0 4", "0 3 0 3 0 3").replace(
    "create_box 1 box", "create_box 1 box bond/types 2 "
    "extra/bond/per/atom 14").replace(
    "boundary p p p", "boundary p p p\nspecial_bonds lj/coul 0.0 1.0 1.0") \
    + """bond_style harmonic
bond_coeff 1 50.0 1.0
bond_coeff 2 30.0 1.2
create_bonds many all all 1 0.9 1.2
thermo_style custom step pe ebond press bonds
run 0
delete_bonds all bond 1
run 0
delete_bonds all bond 1 undo
run 0
delete_bonds all stats
run 0
"""

SINGLE = """units lj
atom_style molecular
boundary p p p
region box block 0 10 0 10 0 10
create_box 2 box bond/types 2 angle/types 1 dihedral/types 1 \
extra/bond/per/atom 3 extra/angle/per/atom 3 extra/dihedral/per/atom 2
create_atoms 1 single 2.0 2.0 2.0 units box
create_atoms 2 single 3.0 2.1 2.0 units box
create_atoms 1 single 3.6 3.0 2.2 units box
create_atoms 2 single 4.7 3.1 2.9 units box
create_atoms 1 single 5.2 4.0 3.0 units box
mass * 1.0
pair_style lj/cut 2.0
pair_coeff * * 0.1 1.0
bond_style harmonic
bond_coeff 1 80.0 1.1
bond_coeff 2 60.0 1.2
angle_style harmonic
angle_coeff 1 30.0 110.0
dihedral_style harmonic
dihedral_coeff 1 2.0 1 2
create_bonds single/bond 1 1 2
create_bonds single/bond 2 2 3
create_bonds single/bond 1 3 4
create_bonds single/bond 2 4 5
create_bonds single/angle 1 1 2 3
create_bonds single/angle 1 2 3 4
create_bonds single/angle 1 3 4 5
create_bonds single/dihedral 1 1 2 3 4
create_bonds single/dihedral 1 2 3 4 5
group two id 2 3
thermo_style custom step pe ebond eangle edihed press
run 0
delete_bonds two multi any
run 0
delete_bonds all bond 2 undo
run 0
delete_bonds all atom 1 undo
run 0
delete_bonds all angle * remove
run 0
delete_bonds all dihedral 1 any remove
run 0
"""

VELOCITY = m2.MELT_HEAD + """velocity all create 1.44 87287 loop geom
fix 1 all nve
run 20
velocity all scale 2.0
velocity all zero angular
run 0
velocity all zero linear
velocity all scale 0.5
thermo_style custom step temp pe ke
run 2
"""

VARIABLES = m2.MELT_HEAD.replace("0 4 0 4 0 4", "0 3 0 3 0 3") + """\
velocity all create 1.44 87287 loop geom
variable w atom mass*x+random(0,1,33)
variable w2 atom v_w*2+vx*vx
variable wv world 2.5 3.5
variable e equal v_wv*2+is_defined(variable,w)
balance 1.0 rcb weight var w2
thermo_style custom step pe v_e
run 0
"""

CASES = {"molecule": MOLECULE, "random": RANDOM, "water": WATER,
         "bonds": BONDS, "single": SINGLE, "velocity": VELOCITY,
         "variables": VARIABLES}


def _script(pkg, directory, text, log):
    path = Path(directory) / "in.t"
    path.write_text(text)
    (Path(directory) / "wat.mol").write_text(cm.WAT_MOL)
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64, log=log)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu", log=log)
    s.file(str(path))
    return s


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (JAX script, port script, JAX log, port log)}, run once."""
    out = {}
    for name, text in CASES.items():
        d = tmp_path_factory.mktemp(name)
        logs = ([], [])
        out[name] = (_script("jax", d, text, logs[0].append),
                     _script("torch", d, text, logs[1].append), *logs)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_rows_match_jax(runs, name):
    js, ts = runs[name][:2]
    assert [r["step"] for r in ts.thermo_rows] == \
        [int(r["step"]) for r in js.thermo_rows]
    for rt, rj in zip(ts.thermo_rows, js.thermo_rows):
        for c, v in rj.items():
            if c in ("atoms", "bonds", "angles", "dihedrals", "impropers"):
                assert int(rt.get(c, v)) == int(v)
                continue
            assert abs(float(rt[c]) - float(v)) <= ROWS * max(
                1.0, abs(float(v))), (name, rj["step"], c, rt[c], v)


@pytest.mark.parametrize("name", ["molecule", "random", "water", "bonds",
                                  "single"])
def test_topology_matches_jax(runs, name):
    """The atoms (sites and rotations bit for bit where nothing ran), the
    types, charges and molecule IDs, and every topology row with its
    type, as the JAX script holds them."""
    js, ts = runs[name][:2]
    for a in ("type", "q", "mol"):
        np.testing.assert_array_equal(np.asarray(getattr(ts, a)),
                                      np.asarray(getattr(js, a)))
    if name in ("random",):
        np.testing.assert_array_equal(ts.x, np.asarray(js.x))
    for fam in ("bond", "angle", "dihedral", "improper"):
        tr, jr = getattr(ts, f"_{fam}s"), getattr(js, f"_{fam}s", None)
        if jr is None or not len(jr):
            assert tr is None or not len(tr)
            continue
        np.testing.assert_array_equal(np.asarray(tr), np.asarray(jr))
        np.testing.assert_array_equal(
            np.asarray(getattr(ts, f"_{fam}_types")),
            np.asarray(getattr(js, f"_{fam}_types")))


def test_water_template_is_the_golden_one():
    """chip_smoke.py's template (the port's inputs import no JAX test) is
    test_molecule_create_atoms_golden's WAT_MOL."""
    assert chip_smoke.WATER_MOL == cm.WAT_MOL


def test_template_sites_bit_for_bit(tmp_path):
    """create_atoms 0 box mol wat 4523: every rotated site equals JAX's
    bit for bit (the RanMars stream and the quaternion's matrix)."""
    head = MOLECULE.split("mass 1")[0]
    js = _script("jax", tmp_path, head, lambda line: None)
    ts = _script("torch", tmp_path, head, lambda line: None)
    assert ts.x.shape == (81, 3)
    np.testing.assert_array_equal(ts.x, np.asarray(js.x))


def test_molecule_golden(runs):
    """test_molecule_create_atoms_golden: 27 molecules, their bonds and
    angles, MOL_GOLDEN's rows at the JAX test's bars."""
    s = runs["molecule"][1]
    assert s.x.shape[0] == 81
    assert len(s._bonds) == 54 and len(s._angles) == 27
    rows = {int(r["step"]): r for r in s.thermo_rows}
    for step, t, pe, eb, ea, pr in cm.MOL_GOLDEN:
        r = rows[step]
        assert float(r["temp"]) == pytest.approx(t, rel=1e-10, abs=1e-15)
        assert float(r["pe"]) == pytest.approx(pe, rel=1e-10)
        assert float(r["ebond"]) == pytest.approx(eb, rel=1e-10)
        assert float(r["eangle"]) == pytest.approx(ea, rel=1e-10)
        assert float(r["press"]) == pytest.approx(pr, rel=1e-9)


def test_create_delete_bonds_golden(runs):
    """test_create_delete_bonds_golden's 648 bonds and four rows."""
    s = runs["bonds"][1]
    assert len(s._bonds) == 648
    assert len(s.thermo_rows) == 4
    for row, (pe, eb, pr) in zip(s.thermo_rows, m2.BONDS_GOLDEN):
        assert float(row["pe"]) == pytest.approx(pe, rel=1e-11)
        assert float(row["ebond"]) == pytest.approx(eb, abs=1e-11)
        assert float(row["press"]) == pytest.approx(pr, rel=1e-10)
        assert float(row["bonds"]) == 648


def test_delete_bonds_logs(runs):
    """delete_bonds' count lines, as the JAX package logs them."""
    for name in ("bonds", "single"):
        jlog, tlog = runs[name][2:]
        keep = [x for x in tlog if " total " in x]
        assert keep and keep == [x for x in jlog if " total " in x]


def test_velocities_match_jax(runs):
    js, ts = runs["velocity"][:2]
    n = ts._sim.natoms
    np.testing.assert_allclose(ts._sim.sys.v[:n].numpy(),
                               np.asarray(js._sim.sys.v)[:n], rtol=0,
                               atol=1e-12)
    # zero angular then zero linear leave no momentum and no spin
    v = ts.v
    assert np.abs(v.sum(0)).max() < 1e-12


def test_atom_variables(runs):
    """The atom-style formulas against JAX's on the same state (random()
    on the atom stream included, each package's stream fresh), balance's
    weight var, the world value substituted, is_defined, and the library's
    extract_variable of an atom-style variable."""
    from lidp_tpu_torch import api

    js, ts, jlog, tlog = runs["variables"]
    keep = [x for x in tlog if x.startswith(("  rcb", "  initial/final"))]
    assert keep == [x for x in jlog if x.startswith(("  rcb",
                                                      "  initial/final"))]
    assert ts.variables["wv"] == "2.5" and ts._world_vars["wv"] == ["2.5",
                                                                   "3.5"]
    assert float(ts.thermo_rows[0]["v_e"]) == 6.0
    js._rng_atom = ts._rng_atom = None
    a = ts.evaluate_atom_expr("v_w2")
    b = np.asarray(js.evaluate_atom_expr("v_w2"))
    np.testing.assert_allclose(a, b, rtol=1e-14)
    with pytest.raises(ValueError, match="atom-style variable"):
        ts.evaluate_expr("v_w+1")
    lib = api.lammps(device="cpu")
    lib.lmp = ts
    ts._rng_atom = None
    got = lib.extract_variable("w")
    ts._rng_atom = None
    np.testing.assert_array_equal(got, ts.evaluate_atom_expr("v_w"))


def test_create_bonds_many_at_scale(tmp_path):
    """create_bonds many on in.lj's 32,000-atom fcc lattice: the k-d tree's
    candidates, not an N x N matrix; every atom gets its 12 nearest
    neighbours, each bond inside [rmin, rmax] under the minimum image, in
    (i, j) order."""
    s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                             log=lambda line: None)
    s.root = str(tmp_path)
    s.execute(m2.MELT_HEAD.replace("atom_style atomic", "atom_style bond")
              .replace("0 4 0 4 0 4", "0 20 0 20 0 20").splitlines())
    s.one("create_bonds many all all 1 1.1 1.3")
    b = s._bonds - 1
    n = len(s.x)
    assert n == 32000 and len(b) == 6 * n
    assert np.all(np.bincount(b.ravel(), minlength=n) == 12)
    L = s.box_hi - s.box_lo
    d = s.x[b[:, 0]] - s.x[b[:, 1]]
    d -= np.round(d / L) * L
    r = np.sqrt((d * d).sum(1))
    assert r.min() >= 1.1 and r.max() <= 1.3
    assert np.all(np.diff(b[:, 0] * n + b[:, 1]) > 0)


def test_unported_create_bonds(tmp_path):
    s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                             log=lambda line: None)
    s.root = str(tmp_path)
    s.execute(SINGLE.split("create_bonds")[0].splitlines())
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        s.one("create_bonds single/improper 1 1 2 3 4")
    with pytest.raises(NotImplementedError, match="queue 3 item 11"):
        s.one("create_bonds many all all 1 0.9 1.2 special no")


CLI_SINGLE = SINGLE + """create_atoms 1 random 3 991 NULL
variable w atom mass*x
variable wv world 1.5 2.5
variable e equal v_wv+count(all)
velocity all create 1.0 4928 loop geom
velocity all zero angular
velocity all scale 1.2
thermo_style custom step pe ebond ke v_e
run 0
"""


@pytest.mark.parametrize("case", ["water", "single"])
def test_cli(tmp_path, case):
    """python -m lidp_tpu_torch -in on the water case (molecule, create_atoms
    mol, dielectric, velocity scale, delete_bonds) and on the single/*
    bonds with create_atoms random, atom- and world-style variables and
    velocity zero angular: the log's rows are the library's."""
    text = {"water": WATER, "single": CLI_SINGLE}[case]
    (tmp_path / "in.w").write_text(text)
    (tmp_path / "wat.mol").write_text(chip_smoke.WATER_MOL)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "lidp_tpu_torch", "-in", "in.w", "-log",
         "log.w", "-device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = chip_smoke.log_rows((tmp_path / "log.w").read_text()
                               .splitlines())
    s = _script("torch", tmp_path, text, lambda line: None)
    assert len(rows) == len(s.thermo_rows) > 1
    for r, t in zip(rows, s.thermo_rows):
        for c, v in r.items():
            assert v == pytest.approx(float(t[c]), rel=1e-7, abs=1e-7)
