"""examples/crack, flow (Couette and Poiseuille) and obstacle through the
port's script front end (lidp_tpu_torch/io/script.py, sim.py) against the
JAX package's LammpsScript (what its CLI runs), float64 on the CPU, both
in one process.  The scripts are LAMMPS's in.crack, in.flow.couette,
in.flow.pois and in.obstacle as shipped (chip_smoke.CRACK_SCRIPT, ...);
only their run lengths are cut (chip_smoke.cut_run), and in.crack's
region for the run held to JAX:

  * in.crack on `region box block 0 40 0 16` (1,337 atoms; `boundary s s
    p`, 5 atom types, velocity create ... temp, velocity ramp ... sum yes,
    setforce NULL, thermo_modify temp, neigh_modify exclude type) above
    a dense cap mocked to 1,000 atoms: the cell grid with the
    shrink-wrapped box, run 200;
  * in.flow.couette and in.flow.pois (420 atoms, `boundary p s p`,
    temp/rescale with fix_modify temp, thermo_modify temp), run 100, and
    in.obstacle (region sphere, delete_atoms, two fix indent, aveforce,
    addforce), run 30, on the dense route;
  * every row within rel 1e-8 of max(1, |value|) of JAX's, x within
    1e-8, the atom counts and the log's `Created` / `Deleted` lines
    equal; obstacle's count in tests/test_obstacle.py's band;
  * in.crack (8,141 atoms, the cell grid) and in.flow.couette at their
    stock sizes, one evaluation (run 0) in the port alone: step 0
    against LAMMPS's logs at tests/test_crack.py's and test_flow.py's
    bars, the atom count and Volume;
  * `python -m lidp_tpu_torch -in` on in.flow.couette (run 100) logs the
    in-process rows;
  * fix_modify temp on temp/rescale and temp/berendsen over all atoms
    (in.flow.couette's fix so changed, run 60): the rows equal to JAX's,
    the rescale reaching the compute group's target;
  * thermo_modify temp and fix_modify's checks: an unknown compute or
    fix, and fix_modify on a fix that reads no temperature or with
    another keyword (the JAX package stores them unread), raise.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu import sim as jsim  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.parallel import fast_polar  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ROWS = 1e-8
X_TOL = 1e-8

# log.5Oct16.crack.g++.1 step 0 (Temp E_pair TotEng Press) at
# tests/test_crack.py's bars, and its Volume
CRACK_GOLD0 = dict(temp=(0.065651733, 5e-9), epair=(-3.2595015, 5e-7),
                   etotal=(-3.1987287, 5e-7), press=(-0.036239172, 5e-8),
                   vol=(8605.5917, 5e-5))
# log.5Oct16.flow.couette.g++.1 step 0 at tests/test_flow.py's bars
FLOW_GOLD0 = dict(temp=(1.0, 1e-9), epair=(0.0, 1e-9),
                  etotal=(0.71190476, 1e-7), press=(0.52314537, 1e-7),
                  vol=(571.54286, 1e-4))

CRACK_CUT = chip_smoke.cut_run(chip_smoke.CRACK_SCRIPT.replace(
    "block 0 100 0 40", "block 0 40 0 16"), 200)
EXAMPLES = {
    "crack": (CRACK_CUT, 1000),
    "couette": (chip_smoke.cut_run(chip_smoke.FLOW_COUETTE_SCRIPT, 100),
                None),
    "pois": (chip_smoke.cut_run(chip_smoke.FLOW_POIS_SCRIPT, 100), None),
    "obstacle": (chip_smoke.cut_run(chip_smoke.OBSTACLE_SCRIPT, 30), None),
}


def _run(pkg, text, cap=None):
    logs = []
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64, log=logs.append)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                                 log=logs.append)
    if cap is None:
        s.execute(text.splitlines())
        return s, logs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsim, "DENSE_PATH_MAX_ATOMS", cap)
        mp.setattr(fast_polar, "DENSE_PATH_MAX_ATOMS", cap)
        s.execute(text.splitlines())
    return s, logs


@pytest.fixture(scope="module")
def runs():
    """Each example through both packages, once: name -> (jax script, its
    log, port script, its log)."""
    out = {}
    for name, (text, cap) in EXAMPLES.items():
        out[name] = (*_run("jax", text, cap), *_run("torch", text, cap))
    return out


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_rows_match_jax(runs, name):
    js, jlog, ts, tlog = runs[name]
    trows, jrows = ts.thermo_rows, js.thermo_rows
    nrun = int(EXAMPLES[name][0].split("\nrun\t\t")[1])
    assert [r["step"] for r in trows] == [0, nrun]
    assert [r["step"] for r in jrows] == [0, nrun]
    for tr, jr in zip(trows, jrows):
        for k, v in tr.items():
            if k in jr and isinstance(v, float):
                assert abs(v - jr[k]) <= ROWS * max(1.0, abs(jr[k])), (
                    tr["step"], k, v, jr[k])
    n = ts._sim.natoms
    assert n == js._sim.natoms
    assert float(np.abs(ts._sim.sys.x[:n].numpy()
                        - np.asarray(js._sim.sys.x)[:n]).max()) <= X_TOL

    def counts(log):
        return [line for line in log
                if line.startswith(("Created", "Deleted"))]

    assert counts(tlog) == counts(jlog)
    route = ts._sim.runner.neighbor_cfg
    assert (route is not None) == (name == "crack")


def test_crack_cut_shrink_wraps(runs):
    """The box follows the atoms (x and y faces at their extent +- small,
    the created length's 1e-4) and the pulled layer widens it."""
    _, _, ts, _ = runs["crack"]
    sim = ts._sim
    assert sim.sys.box.periodic == (False, False, True)
    x = sim.sys.x[:sim.natoms].numpy()
    small = 1e-4 * (ts._created_box[1] - ts._created_box[0])
    lo, hi = sim.sys.box.lo.numpy(), sim.sys.box.hi.numpy()
    # the box is the extent at the last rebuild: within the skin of now
    assert np.all(np.abs(lo[:2] - (x[:, :2].min(0) - small[:2])) < 0.3)
    assert np.all(np.abs(hi[:2] - (x[:, :2].max(0) + small[:2])) < 0.3)
    rows = ts.thermo_rows
    assert rows[-1]["ly"] > rows[0]["ly"]


def test_obstacle_voids(runs):
    """tests/test_obstacle.py's count band, the voids cleared by
    delete_atoms and kept by the indenters."""
    _, _, ts, _ = runs["obstacle"]
    n = ts._sim.natoms
    assert 765 <= n <= 771
    x = ts._sim.sys.x[:n].numpy()
    s3 = ts._spacing3()
    for cx, cy, rad in ((10, 4, 4), (20, 7, 4)):
        c = np.array([cx * s3[0], cy * s3[1], 0.0])
        d = np.linalg.norm((x - c)[:, :2], axis=1)
        assert (d < 0.55 * rad * s3[0]).sum() == 0, d.min()


@pytest.mark.parametrize("name,text,gold,natoms", [
    ("crack", chip_smoke.CRACK_SCRIPT, CRACK_GOLD0, 8141),
    ("couette", chip_smoke.FLOW_COUETTE_SCRIPT, FLOW_GOLD0, 420)],
    ids=["crack", "couette"])
def test_stock_step0_matches_lammps(name, text, gold, natoms):
    ts, _ = _run("torch", chip_smoke.cut_run(text, 0))
    assert ts._sim.natoms == natoms
    assert (ts._sim.runner.neighbor_cfg is not None) == (name == "crack")
    r = ts.thermo_rows[0]
    for k, (want, bar) in gold.items():
        assert abs(r[k] - want) < bar, (k, r[k], want)


def test_cli_runs_couette(tmp_path, runs):
    """`python -m lidp_tpu_torch -in in.flow.couette` (run 100) logs the
    in-process rows as printed."""
    _, _, _, tlog = runs["couette"]
    (tmp_path / "in.flow").write_text(EXAMPLES["couette"][0])
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   filter(None, (str(ROOT), os.environ.get("PYTHONPATH")))))
    out = subprocess.run(
        [sys.executable, "-m", "lidp_tpu_torch", "-in", "in.flow", "-log",
         "log.flow", "-device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    log = (tmp_path / "log.flow").read_text().splitlines()
    rows = chip_smoke.log_rows(log)
    assert rows == chip_smoke.log_rows(tlog)
    assert len(rows) == 2


# in.flow.couette with its temperature fix on all atoms, every 20 steps
# and with no window: fix_modify temp mobile makes it rescale by the flow
# group's temperature (a compute group other than the fix's)
TEMP_FIXES = {
    "temp/rescale": "fix 2 all temp/rescale 20 1.0 1.0 0.0 1.0",
    "temp/berendsen": "fix 2 all temp/berendsen 1.0 1.0 0.1",
}


@pytest.mark.parametrize("name", list(TEMP_FIXES))
def test_fix_modify_temp_matches_jax(name):
    """fix_modify 2 temp mobile on a fix over all atoms: the rows (Temp
    the compute's, thermo_modify temp) equal to JAX's every 20 steps; the
    rescale brings the compute's Temp to its target 1.0 at steps 20, 40,
    60 (the all group's temperature would not)."""
    text = chip_smoke.cut_run(chip_smoke.FLOW_COUETTE_SCRIPT.replace(
        "fix	     2 flow temp/rescale 200 1.0 1.0 0.02 1.0",
        TEMP_FIXES[name]).replace("thermo		500", "thermo		20"), 60)
    assert TEMP_FIXES[name] in text
    (js, _), (ts, _) = _run("jax", text), _run("torch", text)
    assert ts._fix_modify == {"2": {"temp": "mobile"}}
    trows, jrows = ts.thermo_rows, js.thermo_rows
    assert [r["step"] for r in trows] == [0, 20, 40, 60]
    for tr, jr in zip(trows, jrows):
        for k, v in tr.items():
            if k in jr and isinstance(v, float):
                assert abs(v - jr[k]) <= ROWS * max(1.0, abs(jr[k])), (
                    tr["step"], k, v, jr[k])
    if name == "temp/rescale":
        for r in trows[1:]:
            assert abs(r["temp"] - 1.0) < 1e-12


MODIFY = chip_smoke.FLOW_COUETTE_SCRIPT.split("# Couette flow")[0]
MODIFY_ERRORS = {
    "thermo_modify temp unknown": ("thermo_modify temp nosuch", ValueError,
                                   "thermo_modify temperature ID"),
    "fix_modify unknown fix": ("fix_modify 9 temp mobile", ValueError,
                               "fix_modify ID 9"),
    "fix_modify unknown compute": ("fix_modify 2 temp nosuch", ValueError,
                                   "temperature ID nosuch"),
    "fix_modify nve": ("fix_modify 1 temp mobile", NotImplementedError,
                       "queue 3 item 11"),
    "fix_modify energy": ("fix_modify 2 energy yes", NotImplementedError,
                          "queue 3 item 11"),
}


@pytest.mark.parametrize("name", list(MODIFY_ERRORS))
def test_modify_checks(name):
    line, exc, msg = MODIFY_ERRORS[name]
    ts, _ = _run("torch", MODIFY)
    assert ts._fix_modify == {"2": {"temp": "mobile"}}
    with pytest.raises(exc, match=msg):
        ts.one(line)
