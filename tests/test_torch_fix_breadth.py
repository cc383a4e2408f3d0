"""The rest of the modifier fixes and the integrator styles of
lidp_tpu_torch (styles/fix_integrators.py, styles/fix_modifiers.py,
integrate/nvt.py, integrate/npt.py, sim.py) against the JAX package's,
float64 on the CPU, both packages' LammpsScript (what their CLIs run) on
the same scripts:

  * nve/limit, nve/noforce, spring/rg, drag and heat on the 256-atom melt
    of scripts/gen_fix_goldens.py, press/berendsen, dt/reset, restrain
    (its K ramped over two runs), store/force read by compute reduce max,
    the three ehex cases, halt, temp/csvr, the point-sphere nvt/sphere,
    npt/sphere and nph/sphere on test_sphere_nh's eight spheres, and
    spring/chunk with restrain on a seeded bead-spring layout
    (chip_smoke.chain_script_case): every row within rel 1e-8 of
    max(1, |JAX's value|), and the rows of the rebuilt reference that the
    JAX tests hold (their GOLDEN tables, imported) at those tests' own
    tolerances.  spring/chunk's reference rows read examples/micelle's
    data file, which the repository does not hold: they wait for it;
  * what of these styles the JAX package skips unread or refuses raises.

Each script runs once per package in a module-scoped fixture.
"""

import importlib.util
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
from tests import test_ehex as ehex  # noqa: E402
from tests import test_fix_breadth as fb  # noqa: E402
from tests import test_fix_breadth2 as fb2  # noqa: E402
from tests import test_more_fixes as more  # noqa: E402
from tests import test_sphere_nh as sph  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "gen_fix_goldens",
    Path(__file__).resolve().parent.parent / "scripts" / "gen_fix_goldens.py")
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

ROWS = 1e-8
MELT = gen.HEAD.format(bc="p p p")

CHAIN = """\
units lj
atom_style bond
special_bonds fene
read_data data.chain
neighbor 0.4 bin
bond_style fene
bond_coeff 1 30.0 1.5 1.0 1.0
pair_style lj/cut 1.12
pair_modify shift yes
pair_coeff 1 1 1.0 1.0 1.12
timestep 0.005
compute cm all chunk/atom molecule
compute comc all com/chunk cm
fix 1 all nve
fix 2 all spring/chunk 20.0 cm comc
fix 3 all restrain bond 1 30 10.0 20.0 1.5 angle 5 6 7 5.0 8.0 100.0 \
dihedral 40 41 42 43 2.0 4.0 60.0
thermo 5
thermo_style custom step temp pe ke etotal press
run 10
run 5
"""

# name -> the script (the sphere cases write data.sph8 first)
CASES = {
    **{c: gen.script_for(c) for c in ("nve_limit", "nve_noforce",
                                      "spring_rg", "drag", "heat")},
    "press_berendsen": MELT + (
        "fix 1 all nve\n"
        "fix 2 all press/berendsen iso 0.5 0.5 10.0 modulus 50.0\n"
        "thermo 2\nthermo_style custom step temp pe press vol\nrun 4\n"),
    "dt_reset": fb2.MELT + (
        "velocity all create 3.0 87287 loop geom\nfix 1 all nve\n"
        "fix 2 all dt/reset 1 NULL NULL 0.02 units box\n"
        "thermo 2\nthermo_style custom step dt temp pe press\n"
        + fb2.FMT + "run 8\n"),
    "restrain": fb2.MELT.replace(
        "atom_style atomic", "atom_style atomic\natom_modify map array") + (
        "velocity all create 1.44 87287 loop geom\nfix 1 all nve\n"
        "fix 2 all restrain bond 1 6 50.0 80.0 1.5 "
        "angle 1 2 3 30.0 30.0 90.0 dihedral 1 2 3 4 10.0 20.0 120.0\n"
        "thermo 2\nthermo_style custom step temp pe press\n"
        + fb2.FMT + "run 8\nrun 4\n"),
    "store_force": fb2.MELT + (
        "velocity all create 1.44 87287 loop geom\nfix 1 all nve\n"
        "fix sf all store/force\nfix 3 all viscous 0.5\n"
        "compute r1 all reduce max f_sf[1] f_sf[2] fx fy\nthermo 2\n"
        "thermo_style custom step temp c_r1[1] c_r1[2] c_r1[3] c_r1[4]\n"
        + fb2.FMT + "run 4\n"),
    **{f"ehex_{c}": ehex.HEAD + ehex.CASES[c] + ehex.TAIL
       for c in ehex.CASES},
    "halt": more.SETUP + ("fix 1 all nve\nfix 2 all halt 10 temp > 0.0 "
                          "break\nthermo 10\nrun 100\n"),
    "csvr": MELT + ("fix 1 all nve\nfix 2 left temp/csvr 0.7 0.7 0.1 4928\n"
                    "thermo 10\nthermo_style custom step temp pe press\n"
                    "run 40\n"),
    "nvt_sphere": sph.HEAD + "fix 1 all nvt/sphere temp 0.2 0.2 0.5\n"
    + sph.TAIL,
    "npt_sphere": sph.HEAD + ("fix 1 all npt/sphere temp 1.0 1.0 0.5 iso "
                              "0.1 0.1 5.0\n") + sph.TAIL,
    "nph_sphere": sph.HEAD + "fix 1 all nph/sphere iso 0.1 0.1 5.0\n"
    + sph.TAIL,
    "spring_chunk": CHAIN,
}


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
    """Each case's (JAX script, port script), run once."""
    out = {}
    for name, text in CASES.items():
        d = tmp_path_factory.mktemp(name)
        if name.endswith("sphere"):
            (d / "data.sph8").write_text(sph.DATA)
        if name == "spring_chunk":
            chip_smoke.chain_script_case(str(d), n_chains=8, n_beads=25)
        out[name] = (_script("jax", d, text), _script("torch", d, text))
    return out


def _rows(s, cols):
    return np.array([[float(r[c]) for c in cols] for r in s.thermo_rows])


@pytest.mark.parametrize("name", list(CASES))
def test_rows_match_jax(runs, name):
    js, ts = runs[name]
    assert len(ts.thermo_rows) == len(js.thermo_rows) > 1
    for rj, rt in zip(js.thermo_rows, ts.thermo_rows):
        # the JAX row's topology counts (angles, dihedrals, impropers) are
        # not thermo keywords of the port's
        for c, v in rj.items():
            if c in ("atoms", "bonds", "angles", "dihedrals", "impropers") \
                    or not np.isfinite(float(v)):
                continue
            assert abs(float(rt[c]) - float(v)) <= ROWS * max(
                1.0, abs(float(v))), (name, rj["step"], c, rt[c], v)
    # the final state too
    n = ts._sim.natoms
    for a in ("x", "v"):
        xj = np.asarray(getattr(js._sim.sys, a))[:n]
        xt = getattr(ts._sim.sys, a)[:n].numpy()
        assert np.abs(xt - xj).max() <= ROWS * max(1.0, np.abs(xj).max())


@pytest.mark.parametrize("case", ["nve_limit", "nve_noforce", "spring_rg",
                                  "drag", "heat"])
def test_gen_fix_goldens(runs, case):
    """tests/test_fix_breadth.py's rows of the rebuilt reference, at its
    bars (1e-8 of the column's largest value, press 1e-6)."""
    rows = _rows(runs[case][1], fb.COLS)
    gold = np.array(fb.GOLDEN[case])
    assert rows.shape == gold.shape
    for col in range(1, len(fb.COLS)):
        scale = max(1e-10, np.abs(gold[:, col]).max())
        tol = 1e-6 if fb.COLS[col] == "press" else 1e-8
        assert np.abs(rows[:, col] - gold[:, col]).max() < tol * scale


def test_press_berendsen_golden(runs):
    rows = {int(r["step"]): r for r in runs["press_berendsen"][1].thermo_rows}
    for step, temp, pe, press, vol in fb.PB_GOLDEN:
        r = rows[step]
        assert float(r["temp"]) == pytest.approx(temp, rel=1e-10)
        assert float(r["pe"]) * 256 == pytest.approx(pe, rel=1e-9)
        assert float(r["press"]) == pytest.approx(press, rel=1e-8)
        assert float(r["vol"]) == pytest.approx(vol, rel=1e-10)


def test_breadth2_goldens(runs):
    """test_fix_breadth2's dt/reset, restrain and store/force rows."""
    rows = {int(r["step"]): r for r in runs["dt_reset"][1].thermo_rows}
    for step, dt, temp, pe, press in fb2.DTRESET_GOLDEN:
        r = rows[step]
        assert float(r["dt"]) == pytest.approx(dt, rel=1e-12)
        assert float(r["temp"]) == pytest.approx(temp, rel=1e-11)
        assert float(r["pe"]) == pytest.approx(pe, rel=1e-11)
        assert float(r["press"]) == pytest.approx(press, rel=1e-10)
    # the first run's rows (the second run ramps K again from its start)
    rows = runs["restrain"][1].thermo_rows[:5]
    rows = {int(r["step"]): r for r in rows}
    for step, temp, pe, press in fb2.RESTRAIN_GOLDEN:
        r = rows[step]
        assert float(r["temp"]) == pytest.approx(temp, rel=1e-10)
        assert float(r["pe"]) == pytest.approx(pe, rel=1e-10)
        assert float(r["press"]) == pytest.approx(press, rel=1e-9)
    rows = {int(r["step"]): r for r in runs["store_force"][1].thermo_rows}
    for step, temp, s1, s2, fx, fy in fb2.STOREFORCE_GOLDEN:
        r = rows[step]
        assert float(r["temp"]) == pytest.approx(temp, rel=1e-10)
        for c, g in (("c_r1[1]", s1), ("c_r1[2]", s2), ("c_r1[3]", fx),
                     ("c_r1[4]", fy)):
            assert float(r[c]) == pytest.approx(g, rel=1e-9)


@pytest.mark.parametrize("case", sorted(ehex.CASES))
def test_ehex_golden(runs, case):
    rows = _rows(runs[f"ehex_{case}"][1], ehex.COLS)
    gold = np.array(ehex.GOLDEN[case])
    assert rows.shape == gold.shape
    for col in range(1, len(ehex.COLS)):
        scale = max(1e-10, np.abs(gold[:, col]).max())
        tol = 1e-6 if ehex.COLS[col] == "press" else 1e-8
        assert np.abs(rows[:, col] - gold[:, col]).max() < tol * scale


def test_halt_stops_run(runs):
    """test_more_fixes::test_halt_stops_run: the condition holds at the
    first test, so the run stops at step 10 after that step's row."""
    js, ts = runs["halt"]
    assert int(ts.step) == int(js.step) == 10
    assert [int(r["step"]) for r in ts.thermo_rows] == [0, 10]


def test_sphere_goldens(runs):
    """test_sphere_nh's rows: nvt/sphere and npt/sphere at its bars; nph's
    barostat moves the volume."""
    for name, gold, rel in (("nvt_sphere", sph.NVT_GOLDEN, 1e-10),
                            ("npt_sphere", sph.NPT_GOLDEN, 1e-7)):
        rows = {int(r["step"]): r for r in runs[name][1].thermo_rows}
        for step, t, pr, vol in gold:
            r = rows[step]
            assert float(r["temp"]) == pytest.approx(t, rel=rel)
            assert float(r["press"]) == pytest.approx(pr, rel=rel)
            assert float(r["vol"]) == pytest.approx(
                vol, rel=1e-12 if name == "nvt_sphere" else 1e-10)
    rows = {int(r["step"]): r for r in runs["nph_sphere"][1].thermo_rows}
    assert abs(float(rows[4]["vol"]) - 1000.0) > 1e-6


def test_csvr_relaxes(runs):
    """temp/csvr takes the left half of the melt toward 0.7: its group
    cools from 1.44 (the JAX test's relaxation check, on the group)."""
    ts = runs["csvr"][1]
    sim = ts._sim
    g = torch.as_tensor(ts.groups["left"])
    v = sim.sys.v[g]
    t_left = float((v * v).sum()) / (3 * int(g.sum()) - 3)
    assert 0.4 < t_left < 1.0


REFUSALS = {
    "nve/limit extra": ("fix 1 all nve/limit 0.1 extra",
                        NotImplementedError, "queue 3 item 11"),
    "drag extra": ("fix 1 all nve\nfix 2 all drag 0 0 0 1 0.5 9",
                   NotImplementedError, "queue 3 item 11"),
    "halt attribute": ("fix 1 all nve\nfix 2 all halt 10 tlimit > 100",
                       NotImplementedError, "item 6.1.*queue 3 item 11"),
    "halt action": ("fix 1 all nve\nfix 2 all halt 10 temp > 1 error soft",
                    NotImplementedError, "queue 3 item 11"),
    "press/berendsen dilate": (
        "fix 1 all nve\nfix 2 all press/berendsen iso 1 1 10 dilate all",
        NotImplementedError, "queue 3 item 11"),
    "ehex constrain": ("fix 1 all nve\nfix 2 all ehex 1 1.0 constrain",
                       NotImplementedError, "queue 3 item 11"),
    "ehex empty region": ("region r block 100 101 0 1 0 1\nfix 1 all nve\n"
                          "fix 2 all ehex 1 1.0 region r", ValueError,
                          "selects no atoms"),
    "restrain lbound": ("fix 1 all nve\nfix 2 all restrain lbound 1 2 1 1 1",
                        NotImplementedError, "queue 3 item 11"),
    "adapt pair lj/cut": ("variable r equal ramp(0,1)\nfix 1 all nve\n"
                          "fix 2 all adapt 1 pair lj/cut epsilon * * v_r",
                          NotImplementedError, "queue 3 item 11"),
    "nvt/sphere without spheres": (
        "fix 1 all nvt/sphere temp 1 1 1", ValueError, "atom style sphere"),
    "nvt/sllod": ("fix 1 all nvt/sllod temp 1 1 1", NotImplementedError,
                  "queue 1 item 6.4"),
    "neb": ("fix 1 all neb 1.0", NotImplementedError, "queue 1 item 6.12"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals(tmp_path, name):
    line, exc, msg = REFUSALS[name]
    with pytest.raises(exc, match=msg):
        _script("torch", tmp_path, MELT + line + "\nrun 0\n")
