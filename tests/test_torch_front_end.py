"""The script front end's housekeeping, restart, timer, change_box and
balance commands of lidp_tpu_torch (io/commands.py, io/script.py, sim.py,
utils/checkpoint.py, utils/timing.py, parallel/balance.py) against the
JAX package's LammpsScript on the same scripts, float64 on the CPU, and
against the rebuilt reference's rows that the JAX tests hold (imported
from tests/test_misc_commands2.py and tests/test_misc_commands.py):

  * box, comm_style, suffix, package, info, shell, reset_timestep,
    partition, run_style verlet and write_coeff: the same rows, log lines
    and files; quit and clear;
  * dielectric on the dense route (test_dielectric_golden's rows), the
    Ewald sum, MSM, PPPM on the cell grid (the dense cap mocked to 500 in
    both packages) and the panel engine (LIDP_FAST_POLAR=1, the polar
    fluid);
  * bond_write: test_bond_write_golden's rows, and the JAX file's;
  * restart N file file2: each row printed once and the files
    (test_misc_commands_golden); a run resumed by read_restart against
    the uninterrupted run under nve, nvt and npt (equal rows) and rigid
    molecules (rel 1e-7), and the state read back against the state
    written, bit for bit;
  * timer: timeout (test_timer_timeout_*), and full's breakdown lines;
  * change_box on an orthogonal box: test_change_box_golden's first two
    rows (its third tilts the box, ROADMAP queue 1 item 6.4), final,
    delta, scale, boundary and units lattice, and a change on the cell
    grid between two runs;
  * balance: the JAX package's log lines and stored weights;
  * `python -m lidp_tpu_torch -in` on a script of these commands;
  * what stays out raises, naming its item.

Each script runs once per package in a module-scoped fixture; rows agree
at rel 1e-8 of max(1, |JAX's value|).
"""

import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time, as the port's other parity files
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu import sim as jsim  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.parallel import fast_polar as tfast  # noqa: E402
from lidp_tpu_torch.utils import checkpoint  # noqa: E402
from tests import test_misc_commands as m1  # noqa: E402
from tests import test_misc_commands2 as m2  # noqa: E402

ROWS = 1e-8
REPO = Path(__file__).resolve().parent.parent

BASE = m2.MELT_HEAD.replace("region box block 0 4 0 4 0 4",
                            "region box block 0 3 0 3 0 3") + \
    "velocity all create 1.44 87287 loop geom\n"

MISC = BASE + """fix 1 all nve
compute_modify thermo_temp extra 0
thermo_style custom step temp pe
balance 1.0 shift x 5 1.0
info system
restart 2 rs.a rs.b
run 4
write_coeff coeffs.out
shell mkdir subdir
"""

HOUSE = BASE + """fix 1 all nve
box tilt large
comm_style brick
suffix gpu
package omp 0
run_style verlet
partition yes 1 variable pv equal 2
partition no 1 variable pw equal 3
partition yes 2 variable px equal 4
thermo 1
thermo_style custom step temp pe etotal press
run 2
reset_timestep 100
run 2
info
"""

# a charged melt on the cell grid (864 atoms, the dense cap mocked to 500):
# pppm with dielectric 2, then change_box between two runs
CELLS = m2.MELT_HEAD.replace("atom_style atomic", "atom_style charge") \
    .replace("0 4 0 4 0 4", "0 6 0 6 0 6").replace(
        "create_box 1 box", "create_box 2 box").replace(
        "mass 1 1.0", "mass * 1.0\nset type 1 type/fraction 2 0.5 4321\n"
        "set type 1 charge 0.5\nset type 2 charge -0.5").replace(
        "pair_style lj/cut 2.5\npair_coeff 1 1 1.0 1.0",
        "pair_style lj/cut/coul/long 2.5\npair_coeff * * 1.0 1.0\n"
        "kspace_style pppm 1e-4\ndielectric 2.0") + """\
velocity all create 1.44 87287 loop geom
fix 1 all nve
thermo 1
thermo_style custom step temp pe ecoul elong press vol lx ly
run 2
change_box all x scale 1.05 y delta -0.5 0.5 remap units box
run 2
"""

CBOX = m2.MELT_HEAD + """thermo_style custom step pe press vol lx ly lz xy
run 0
change_box all x scale 1.08 y delta -0.5 0.5 remap units box
run 0
change_box all x final 0 6.5 y delta 0 0.5 z scale 0.98 boundary p p f \
remap
run 0
"""

BALANCE = BASE + """region lo block INF 1.5 INF INF INF INF
group low region lo
variable wv atom 1.0+x/10
balance 1.0 shift x 5 1.0
balance 1.0 rcb weight group 1 low 2.0 weight var wv weight neigh 1.5 \
weight store ws
balance 1.1 shift xyz 10 1.05 weight time 0.5 out bal.out
run 0
"""

MORSE = m2.MELT_HEAD.replace("atom_style atomic", "atom_style bond").replace(
    "create_box 1 box", "create_box 1 box bond/types 1 "
    "extra/bond/per/atom 2") + """bond_style morse
bond_coeff 1 1.0 2.0 1.1
bond_write 1 7 0.9 1.5 bm.table MORSE
"""

BOND_WRITE = """units lj
atom_style bond
boundary p p p
region box block 0 10 0 10 0 10
create_box 1 box bond/types 1 extra/bond/per/atom 2
create_atoms 1 single 2.0 2.0 2.0
create_atoms 1 single 3.0 2.0 2.0
mass 1 1.0
pair_style zero 2.0
pair_coeff * *
bond_style harmonic
bond_coeff 1 80.0 1.1
create_bonds single/bond 1 1 2
bond_write 1 5 0.8 1.4 bw.table HARM
"""

TIMER = BASE + """fix 1 all nve
timer full every 10
run 3
"""

RESUME_FIXES = {"nve": "fix 1 all nve",
                "nvt": "fix 1 all nvt temp 1.44 1.0 0.1",
                "npt": "fix 1 all npt temp 1.44 1.44 0.1 iso 1.0 1.5 0.5"}
RESUME = BASE + """{fix}
thermo 1
thermo_style custom step temp pe etotal press vol
restart 3 ck.a ck.b
run 6
"""

# name -> (script, dense cap or None, environment)
CASES = {
    "misc": (MISC, None, {}),
    "house": (HOUSE, None, {}),
    **{f"diel_{eps}": (m2.DIEL_HEAD + f"dielectric {eps}\nthermo_style "
                       "custom step pe ecoul evdwl\nrun 0\n", None, {})
       for eps in ("1.0", "2.0")},
    **{f"diel_{k}": (m2.DIEL_HEAD.replace("coul/cut", pair) + f"kspace_style "
                     f"{k} 1e-4\ndielectric 2.0\nthermo_style custom step "
                     "pe ecoul elong evdwl press\nrun 0\n", None, {})
       for k, pair in (("ewald", "coul/long"), ("msm", "coul/msm"))},
    "cells": (CELLS, 500, {}),
    "panel": (chip_smoke.FLUID_SCRIPT.replace(
        "kspace_style", "dielectric 2.0\nkspace_style"), None,
        {"LIDP_FAST_POLAR": "1"}),
    "cbox": (CBOX, None, {}),
    "balance": (BALANCE, None, {}),
    "bond_write": (BOND_WRITE, None, {}),
    "morse": (MORSE, None, {}),
    "timer": (TIMER, None, {}),
    **{f"resume_{k}": (RESUME.format(fix=f), None, {})
       for k, f in RESUME_FIXES.items()},
}


def _script(pkg, directory, text, log, variables=None):
    path = Path(directory) / "in.t"
    path.write_text(text)
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64, log=log)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu", log=log)
    s.variables.update(variables or {})
    s.file(str(path))
    return s


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (JAX script, port script, JAX log lines, port log lines,
    JAX directory, port directory)}, each run once."""
    out = {}
    for name, (text, cap, env) in CASES.items():
        cap = cap or jsim.DENSE_PATH_MAX_ATOMS
        dirs = [tmp_path_factory.mktemp(f"{name}_{pkg}")
                for pkg in ("jax", "torch")]
        variables = None
        if name == "panel":
            for d in dirs:
                chip_smoke.fluid_script_case(str(d), n_side=3)
            variables = {"nstep": "1"}
        logs = ([], [])
        with mock.patch.object(jsim, "DENSE_PATH_MAX_ATOMS", cap), \
                mock.patch.object(tfast, "DENSE_PATH_MAX_ATOMS", cap), \
                mock.patch.dict(os.environ, env):
            js = _script("jax", dirs[0], text, logs[0].append, variables)
            ts = _script("torch", dirs[1], text, logs[1].append, variables)
        out[name] = (js, ts, logs[0], logs[1], dirs[0], dirs[1])
    return out


def _agree(name, trows, jrows, skip=("atoms", "bonds", "angles", "dihedrals",
                                      "impropers")):
    assert [int(r["step"]) for r in trows] == [int(r["step"])
                                               for r in jrows]
    for rt, rj in zip(trows, jrows):
        for c, v in rj.items():
            if c in skip:
                continue
            assert abs(float(rt[c]) - float(v)) <= ROWS * max(
                1.0, abs(float(v))), (name, rj["step"], c, rt[c], v)


ROW_CASES = [c for c in CASES if c not in ("bond_write", "morse")]


@pytest.mark.parametrize("name", ROW_CASES)
def test_rows_match_jax(runs, name):
    js, ts = runs[name][:2]
    assert len(ts.thermo_rows) > 0
    _agree(name, ts.thermo_rows, js.thermo_rows)


def test_misc_golden_and_files(runs):
    """test_misc_commands_golden's rows and files: restart's two names,
    write_coeff's text (JAX's), shell mkdir; each step's row once across
    the restart chunks; balance's and info's log lines as JAX's."""
    js, ts, jlog, tlog, dj, dt = runs["misc"]
    rows = {int(r["step"]): r for r in ts.thermo_rows}
    for step, temp, pe in m2.MISC_GOLDEN:
        assert float(rows[step]["temp"]) == pytest.approx(temp, rel=1e-10)
        assert float(rows[step]["pe"]) == pytest.approx(pe, rel=1e-10)
    assert [int(r["step"]) for r in ts.thermo_rows] == [0, 2, 4]
    for f in ("rs.a", "rs.b"):
        assert (dt / f).exists()
    assert (dt / "subdir").is_dir()
    assert (dt / "coeffs.out").read_text() == (dj / "coeffs.out").read_text()
    keep = ("  iteration", "  initial/final", "Info:")
    assert [x for x in tlog if x.startswith(keep)] == \
        [x for x in jlog if x.startswith(keep)]


def test_housekeeping(runs):
    """The no-ops, partition's single-partition emulation, shell putenv,
    reset_timestep's step and info's lines, as in the JAX package."""
    js, ts, jlog, tlog = runs["house"][:4]
    assert [int(r["step"]) for r in ts.thermo_rows] == [0, 1, 2, 100, 101,
                                                        102]
    for s in (js, ts):
        assert "pv" in s._equal_exprs
        assert "pw" not in s._equal_exprs and "px" not in s._equal_exprs
    with mock.patch.dict(os.environ):
        ts.one("shell putenv LIDP_FRONT_END_TEST=7")
        assert os.environ["LIDP_FRONT_END_TEST"] == "7"
    assert [x for x in tlog if x.startswith("Info:")] == \
        [x for x in jlog if x.startswith("Info:")]


@pytest.mark.parametrize("eps,ecoul,pe", m2.test_dielectric_golden.pytestmark[
    0].args[1])
def test_dielectric_golden(runs, eps, ecoul, pe):
    row = runs[f"diel_{eps}"][1].thermo_rows[0]
    assert float(row["ecoul"]) == pytest.approx(ecoul, rel=1e-11)
    assert float(row["pe"]) == pytest.approx(pe, rel=1e-11)
    assert float(row["evdwl"]) == pytest.approx(-0.0530991093085, rel=1e-10)


def test_dielectric_routes(runs):
    """The cell case ran on the cell grid, the fluid on the panel engine,
    both with qqrd2e halved."""
    from lidp_tpu_torch.ops.cells import Cells

    sim = runs["cells"][1]._sim
    assert isinstance(sim.nlist.nlist, Cells)
    assert sim.runner.ff.qqrd2e == pytest.approx(0.5)
    psim = runs["panel"][1]._sim
    assert type(psim.runner).__name__ == "FastPolarRunner"
    assert psim.runner.ff.qqrd2e == pytest.approx(332.06371 / 2.0)


def _table(path):
    return np.array([[float(v) for v in ln.split()]
                     for ln in open(path) if len(ln.split()) == 4
                     and ln.split()[0].isdigit()])


def test_bond_write(runs):
    """test_bond_write_golden's rows and header; the harmonic and morse
    files against JAX's."""
    dt = runs["bond_write"][5]
    gold = [[1, 0.8, 7.2, 48.0], [2, 0.95, 1.8, 24.0], [3, 1.1, 0.0, 0.0],
            [4, 1.25, 1.8, -24.0], [5, 1.4, 7.2, -48.0]]
    assert np.allclose(_table(dt / "bw.table"), gold, rtol=1e-12,
                       atol=1e-12)
    hdr = (dt / "bw.table").read_text()
    assert "N 5 EQ 1.1" in hdr and "HARM" in hdr
    for case, f in (("bond_write", "bw.table"), ("morse", "bm.table")):
        dj, dt = runs[case][4:]
        a, b = _table(dt / f), _table(dj / f)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= ROWS * max(1.0, np.abs(b).max())
        head = [x for x in (dt / f).read_text().splitlines()
                if not x[:1].isdigit()]
        assert head == [x for x in (dj / f).read_text().splitlines()
                        if not x[:1].isdigit()]


def _resume(directory, fix, fname, nsteps):
    lines = []
    s = _script("torch", directory, BASE + f"{fix}\nthermo 1\n"
                "thermo_style custom step temp pe etotal press vol\n"
                f"read_restart {fname}\nrun {nsteps}\n", lines.append)
    return s


@pytest.mark.parametrize("kind", list(RESUME_FIXES))
def test_resume_matches_uninterrupted(runs, kind):
    """read_restart of ck.a (step 3) and 3 steps give the uninterrupted
    run's rows 3-6 exactly, Nose-Hoover and barostat state included; the
    file's state equals the state written at step 6 (ck.b) bit for bit."""
    js, ts, _, _, _, dt = runs[f"resume_{kind}"]
    full = {int(r["step"]): r for r in ts.thermo_rows}
    s = _resume(dt, RESUME_FIXES[kind], "ck.a", 3)
    assert [int(r["step"]) for r in s.thermo_rows] == [3, 4, 5, 6]
    for r in s.thermo_rows:
        for c, v in r.items():
            assert v == full[int(r["step"])][c], (kind, r["step"], c)
    written = checkpoint.flatten_state(ts._sim.sys, ts._sim.istate)
    read = checkpoint.load_checkpoint(str(dt / "ck.b"))
    assert sorted(written) == sorted(read)
    for k, v in written.items():
        assert v.dtype == read[k].dtype and np.array_equal(v, read[k]), k
    if kind != "nve":
        assert any(k.startswith("istate.") and np.any(v != 0)
                   for k, v in read.items())


@pytest.mark.parametrize("panel", ["0", "1"])
def test_rigid_resume(tmp_path, panel):
    """The polar fluid (81 atoms) as rigid molecules, on the dense route
    and the panel engine: read_restart of r.a (step 2) and 2 steps give
    the uninterrupted run's rows at rel 1e-7 of max(1, |value|) (the body
    frame is rebuilt from the positions read, so the quaternions come
    from the new setup, not the file)."""
    chip_smoke.fluid_script_case(str(tmp_path), n_side=3)
    head = chip_smoke.FLUID_SCRIPT.replace("run ${nstep}\n", "")
    with mock.patch.dict(os.environ, {"LIDP_FAST_POLAR": panel}):
        full = _script("torch", tmp_path, head + "restart 2 r.a r.b\n"
                       "run 4\n", lambda line: None)
        part = _script("torch", tmp_path, head + "read_restart r.a\nrun 2\n",
                       lambda line: None)
    rows = {int(r["step"]): r for r in full.thermo_rows}
    assert [int(r["step"]) for r in part.thermo_rows] == [2, 3, 4]
    for r in part.thermo_rows:
        for c, v in r.items():
            ref = rows[int(r["step"])][c]
            assert abs(v - ref) <= 1e-7 * max(1.0, abs(ref)), (r["step"], c)


def test_restart_resume_exact(runs, tmp_path):
    """test_restart_resume_exact's script: restart 2 ck.a over 4 steps,
    then read_restart ck.a and run 0 give step 4's pe (rel 1e-13)."""
    head = BASE + "fix 1 all nve\nthermo_style custom step pe\n"
    s1 = _script("torch", tmp_path, head + "restart 2 ck.a\nrun 4\n",
                 lambda line: None)
    s2 = _script("torch", tmp_path, head + "read_restart ck.a\nrun 0\n",
                 lambda line: None)
    r1 = {int(r["step"]): r for r in s1.thermo_rows}
    r2 = s2.thermo_rows[-1]
    assert int(r2["step"]) == 4
    assert float(r2["pe"]) == pytest.approx(float(r1[4]["pe"]), rel=1e-13)


def test_timer_full(runs):
    """timer full: the breakdown's categories (JAX's) after the Loop time
    lines, and its seconds on the Simulation."""
    jlog, tlog = runs["timer"][2:4]

    def cats(log):
        i = next(k for k, x in enumerate(log) if x.startswith("Loop time"))
        return [x.split()[0] for x in log[i + 2:] if "time (%)" in x]

    assert cats(tlog) == cats(jlog) == ["Pair"]
    t = runs["timer"][1]._sim.timer_breakdown
    assert list(t) == ["Pair"] and t["Pair"] > 0.0


def test_timer_timeout_ends_run_early():
    """test_timer_timeout_ends_run_early through the port's library."""
    from lidp_tpu_torch.api import lammps

    L = lammps(device="cpu")
    L.commands_string(m1.SETUP)
    L.command("timer timeout 0:0:0")
    L.command("run 100")
    assert L.extract_global("ntimestep") == 0
    L.command("timer timeout unlimited")
    L.command("run 10")
    assert L.extract_global("ntimestep") == 10


def test_timer_timeout_parse_formats():
    s = tscript.LammpsScript(device="cpu")
    s.one("timer timeout 3600")
    assert s._timer_timeout == 3600.0
    s.one("timer timeout 1:30")
    assert s._timer_timeout == 90.0
    s.one("timer loop timeout 2:00:00 every 50")
    assert s._timer_timeout == 7200.0 and s._timer_mode == "loop"
    assert s._timer_every == 50
    s.one("timer timeout off")
    assert s._timer_timeout is None


def test_change_box_golden(runs):
    """test_change_box_golden's first two rows (x scale, y delta, remap
    units box).  Its third row, a triclinic xy final, waits for ROADMAP
    queue 1 item 6.4: that change_box raises (test_refusals)."""
    rows = runs["cbox"][1].thermo_rows
    for row, (pe, pr, vol, lx, ly, xy) in zip(rows[:2], m2.CBOX_GOLDEN[:2]):
        assert float(row["pe"]) == pytest.approx(pe, rel=1e-11)
        assert float(row["press"]) == pytest.approx(pr, rel=1e-10)
        assert float(row["vol"]) == pytest.approx(vol, rel=1e-11)
        assert float(row["lx"]) == pytest.approx(lx, rel=1e-11)
        assert float(row["ly"]) == pytest.approx(ly, rel=1e-11)
        assert float(row["xy"]) == pytest.approx(xy, abs=1e-12)


def test_change_box_state(runs):
    """After change_box the atoms, image flags and box are JAX's, and the
    cell grid's second run sees the new box."""
    for case in ("cbox", "cells"):
        js, ts = runs[case][:2]
        n = ts._sim.natoms
        np.testing.assert_allclose(ts._sim.sys.x[:n].numpy(),
                                   np.asarray(js._sim.sys.x)[:n],
                                   rtol=0, atol=1e-9)
        np.testing.assert_array_equal(ts._sim.sys.image[:n].numpy(),
                                      np.asarray(js._sim.sys.image)[:n])
        np.testing.assert_allclose(ts._sim.sys.box.hi.numpy(),
                                   np.asarray(js._sim.sys.box.hi),
                                   rtol=1e-15)
    sim = runs["cells"][1]._sim
    assert not bool(sim.nlist.overflow)


def test_balance(runs):
    """balance's log lines (one device: one block, factors 1) and weight
    store's weights, as the JAX package's without `processors`."""
    js, ts, jlog, tlog = runs["balance"][:4]
    keep = ("  iteration", "  initial/final", "  group weights", "  rcb",
            "  balance weight")
    got = [x for x in tlog if x.startswith(keep)]
    assert got == [x for x in jlog if x.startswith(keep)]
    assert len(got) == 12
    np.testing.assert_allclose(ts.balance_store["ws"],
                               js.balance_store["ws"], rtol=1e-15)
    assert js.shard_perm is None


def test_clear_and_quit(tmp_path):
    """test_clear_and_quit, and a second system after clear: the same rows
    as a fresh interpreter's, with the kernels' memos dropped."""
    from lidp_tpu_torch.ops import cell_kernels

    s = _script("torch", tmp_path, m2.MELT_HEAD + "run 0\nclear\n",
                lambda line: None)
    assert s.x is None and s._sim is None
    assert cell_kernels._PAR_MEMO[1] is None
    with pytest.raises(SystemExit):
        _script("torch", tmp_path, "units lj\nquit\n", lambda line: None)
    s.execute((m2.MELT_HEAD + "run 0\n").splitlines())
    fresh = _script("torch", tmp_path, m2.MELT_HEAD + "run 0\n",
                    lambda line: None)
    assert s.thermo_rows == fresh.thermo_rows


REFUSALS = {
    "run_style respa": ("run_style respa 2 2 bond 1 pair 2", "item 6.10"),
    "neb": ("neb 0.0 0.01 100 100 10 final f.neb", "item 6.12"),
    "prd": ("prd 100 10 10 all 1.0 12345 6789", "item 6.12"),
    "tad": ("tad 100 10 0.1 0.1 1.0 1.0 final", "item 6.12"),
    "temper": ("temper 100 10 1.0 tmp 3847 58382", "item 6.12"),
    "processors": ("processors 2 1 1", "item 7"),
    "change_box triclinic": ("change_box all triclinic", "item 6.4"),
    "change_box xy": ("change_box all xy final 0.8 remap units box",
                      "item 6.4"),
    "reset_timestep keyword": ("reset_timestep 0 time 0.0",
                               "queue 3 item 11"),
    "create_box keyword": None,
    "python": ("python f input 1 v_x return v_y format ff here 'x'",
               "lidp_tpu_torch.api"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals(tmp_path, name):
    s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                             log=lambda line: None)
    s.root = str(tmp_path)
    if name == "create_box keyword":
        s.execute(m2.MELT_HEAD.split("create_box")[0].splitlines())
        with pytest.raises(NotImplementedError, match="queue 1 item 6"):
            s.one("create_box 1 box bond/types 1 extra/foo/per/atom 2")
        return
    s.execute((m2.MELT_HEAD + "run 0\n").splitlines())
    line, item = REFUSALS[name]
    with pytest.raises(NotImplementedError, match=item):
        s.one(line)


def test_cli(tmp_path):
    """python -m lidp_tpu_torch -in on the housekeeping, restart, timer,
    change_box, balance, dielectric and coefficient commands, then clear
    and quit: its log's rows are the library's on the same commands, and
    quit ends it with exit code 0 before its last run."""
    text = (HOUSE.replace("info\n", "") + "restart 2 cli.a cli.b\n"
            "timer full\nchange_box all x scale 1.02 remap\n"
            "balance 1.0 shift x 5 1.0\ndielectric 1.5\nrun 2\n"
            "write_restart cli.w\nwrite_coeff cli.coeff\ninfo\n"
            "read_restart cli.w\nrun 1\nshell mkdir sub\n")
    tail = "clear\nquit\nrun 5\n"
    (tmp_path / "in.cli").write_text(text + tail)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "lidp_tpu_torch", "-in", "in.cli", "-log",
         "log.cli", "-device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = chip_smoke.log_rows((tmp_path / "log.cli").read_text()
                               .splitlines())
    s = _script("torch", tmp_path / "sub", text, lambda line: None)
    assert [int(r["step"]) for r in rows] == [0, 1, 2, 100, 101, 102, 102,
                                              103, 104, 104, 105]
    for r, t in zip(rows, s.thermo_rows):
        for c, v in r.items():
            assert v == pytest.approx(float(t[c]), rel=1e-7, abs=1e-7)
    for f in ("cli.a", "cli.w", "cli.coeff", "sub"):
        assert (tmp_path / f).exists()
