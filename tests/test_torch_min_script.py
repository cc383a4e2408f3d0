"""minimize, min_style, min_modify, fix box/relax, dimension 2, fix
enforce2d, displace_atoms and a run with no time-integration fix through
the port's script front end (lidp_tpu_torch/io/script.py, sim.py)
against the JAX package's LammpsScript (what its CLI runs), float64 on
the CPU, both in one process:

  * examples/min (2d LJ, lattice sq2, 800 atoms, fix nve + fix enforce2d,
    pair_modify shift, then minimize with the default cg) with its run
    cut to 100 steps, as tests/test_min_example.py cuts it, and its
    minimize to 10 iterations: step 0 against LAMMPS's log
    (log.5Oct16.min.g++.1) at test_min_example.py's bars, every row
    within rel 1e-8 of max(1, |value|) of the JAX package's, the atoms
    planar after the run, the `# minimize:` lines equal, the minimized
    E_pair at rel 1e-10 and x within 1e-8;
  * tests/test_min_styles.py's 72-atom input: quickmin (500 iterations)
    and then hftn reach its goldens (rel 1e-7, rel 1e-9) in the port,
    in-process and through `python -m lidp_tpu_torch -in`, whose
    `# minimize:` lines give the JAX package's energies (hftn's
    iteration count, set at its tail by rounding, is not compared);
  * displace_atoms move (box units, across the faces), ramp and random
    (lattice units): x and the image flags equal to the JAX package's;
  * fix box/relax iso 0.0 on a 3d and a 2d case: the box, E_pair and x
    after minimize against the JAX package's;
  * a run with no time-integration fix (atoms frozen): the rows;
  * min_modify refusing a key other than dmax and line quadratic;
  * a 2d box above the dense cap (mocked): the cell grid with one bin
    along z, rows equal to the JAX package's; under 3 bins across, the
    refusal (JAX's neighbour list);
  * minimize (fire, then cg) on the polarizable fluid
    (chip_smoke.fluid_script_case at 192 atoms) on the dense route and
    (cg) on the panel engine: E_pair, x and the `# minimize:` lines.
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
from lidp_tpu import forcefield as jff  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch import forcefield as tff  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ROWS = 1e-8
E_REL = 1e-10
X_TOL = 1e-8

# examples/min (in.min) as LAMMPS ships it, but for the run's and the
# minimization's lengths
MIN_SCRIPT = """\
units		lj
dimension	2
atom_style	atomic

lattice		sq2 0.8442
region		box block 0 20 0 20 -0.1 0.1
create_box	1 box
create_atoms	1 box
mass		1 1.0

velocity	all create 5.0 87287 loop geom

pair_style	lj/cut 2.5
pair_coeff	1 1 1.0 1.0 2.5
pair_modify	shift yes

neighbor	0.3 bin
neigh_modify	delay 0 every 1 check yes

fix		1 all nve
fix		2 all enforce2d

thermo		50
run		100

minimize	1.0e-4 1.0e-6 10 1000
"""
# log.5Oct16.min.g++.1's step 0 (tests/test_min_example.py)
GOLD0 = dict(temp=5.0, epair=-2.461717, etotal=2.532033, press=5.0190509)

# tests/test_min_styles.py's input
STYLES_HEAD = """units lj
dimension 2
atom_style atomic
lattice sq2 0.8442
region box block 0 6 0 6 -0.1 0.1
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
pair_modify shift yes
neighbor 0.3 bin
displace_atoms all random 0.15 0.15 0 424242
fix 2 all enforce2d
"""
QUICKMIN = "min_style quickmin\nminimize 0.0 1.0e-6 500 5000\n"
HFTN = "min_style hftn\nminimize 0.0 1.0e-8 100 5000\n"
GOLD_QUICKMIN = -2.96612445689
GOLD_HFTN = -2.96613896543

FCC = """units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 3 0 3 0 3
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
"""


def _both(text, directory=None):
    """Run `text` through both packages' LammpsScript: (jax script, its log
    lines, port script, its log lines)."""
    out = []
    for pkg in ("jax", "torch"):
        logs = []
        if pkg == "jax":
            s = jscript.LammpsScript(dtype=jnp.float64, log=logs.append)
        else:
            s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                                     log=logs.append)
        if directory is not None:
            path = Path(directory) / f"in.{pkg}"
            path.write_text(text)
            s.file(str(path))
        else:
            s.execute(text.splitlines())
        out += [s, logs]
    return out


def _rows_agree(trows, jrows):
    assert len(trows) == len(jrows)
    for tr, jr in zip(trows, jrows):
        assert tr["step"] == jr["step"]
        for k, v in tr.items():
            if k in jr and isinstance(v, float):
                assert abs(v - jr[k]) <= ROWS * max(1.0, abs(jr[k])), (
                    tr["step"], k, v, jr[k])


def _epair(s, pkg):
    """E_pair of the script's final System and its x (unpadded)."""
    sim = s._sim
    if pkg == "jax":
        res = jff.compute_forces(sim.sys, sim.runner.ff)
        return float(res.epair), np.asarray(sim.sys.x)[:sim.natoms]
    res = tff.compute_forces(sim.sys, sim.runner.ff)
    return float(res.epair), sim.sys.x[:sim.natoms].numpy()


def _min_lines(logs):
    return [line for line in logs if line.startswith("# minimize:")]


def _energy_part(lines):
    return [line.split(" after ")[0] for line in lines]


def _same_minimum(js, jlog, ts, tlog, iterations=True):
    """The `# minimize:` lines equal (but for the iteration counts where
    `iterations` is False), E_pair at rel 1e-10, x within 1e-8."""
    if iterations:
        assert _min_lines(tlog) == _min_lines(jlog)
    else:
        assert _energy_part(_min_lines(tlog)) == _energy_part(
            _min_lines(jlog))
    assert _min_lines(tlog)
    je, jx = _epair(js, "jax")
    te, tx = _epair(ts, "torch")
    assert te == pytest.approx(je, rel=E_REL)
    assert float(np.abs(tx - jx).max()) <= X_TOL
    # the host arrays took the minimized x
    assert np.array_equal(ts.x, tx)
    return te


@pytest.fixture(scope="module")
def in_min():
    return _both(MIN_SCRIPT)


def test_min_example_step0_matches_lammps(in_min):
    _, _, ts, _ = in_min
    r = ts.thermo_rows[0]
    assert abs(r["temp"] - GOLD0["temp"]) < 1e-10
    for k in ("epair", "etotal", "press"):
        assert abs(r[k] - GOLD0[k]) < 5e-7, k


def test_min_example_rows_match_jax(in_min):
    js, _, ts, _ = in_min
    assert [r["step"] for r in ts.thermo_rows] == [0, 50, 100]
    _rows_agree(ts.thermo_rows, js.thermo_rows)


def test_min_example_minimize_matches_jax(in_min):
    js, jlog, ts, tlog = in_min
    e = _same_minimum(js, jlog, ts, tlog)
    natoms = ts._sim.natoms
    assert natoms == 800
    # it relaxed from the melt's E_pair, in the plane, v zeroed
    assert e / natoms < ts.thermo_rows[-1]["epair"]
    sys_ = ts._sim.sys
    assert torch.all(sys_.x[:, 2] == 0.0)
    assert not torch.any(sys_.v)
    assert ts._sim.res is None


def test_min_example_planar():
    """After a run under fix enforce2d, z and v_z stay 0 (test_min_example
    .py's bars): examples/min on a 6 x 6 region, 20 steps."""
    text = MIN_SCRIPT.replace("block 0 20 0 20", "block 0 6 0 6").replace(
        "run		100", "run 20").split("minimize")[0]
    ts = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    ts.execute(text.splitlines())
    sys_ = ts._sim.sys
    assert float(sys_.x[:, 2].abs().max()) < 1e-12
    assert float(sys_.v[:, 2].abs().max()) < 1e-12
    assert float(sys_.v[:, :2].abs().max()) > 0.1


@pytest.fixture(scope="module")
def styles_case():
    return _both(STYLES_HEAD + QUICKMIN + HFTN)


def test_quickmin_hftn_goldens(styles_case):
    """quickmin, then hftn, reach the rebuilt reference's energies and the
    JAX package's minimum.  hftn's iteration counts may differ: near the
    minimum its Armijo test compares energies at their rounding
    (tests/test_torch_minimize.py test_hftn_matches_jax)."""
    js, jlog, ts, tlog = styles_case
    assert len(ts.minimized) == 2
    (eq, itq, _), (eh, _, conv) = ts.minimized
    assert itq == 500
    assert eq / 72 == pytest.approx(GOLD_QUICKMIN, rel=1e-7)
    assert eh / 72 == pytest.approx(GOLD_HFTN, rel=1e-9)
    assert conv
    _same_minimum(js, jlog, ts, tlog, iterations=False)


def test_cli_minimizes(tmp_path, styles_case):
    """`python -m lidp_tpu_torch -in` on the same input logs the port's
    `# minimize:` lines in this process, with the JAX package's
    energies."""
    _, jlog, _, tlog = styles_case
    (tmp_path / "in.h").write_text(STYLES_HEAD + QUICKMIN + HFTN)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   filter(None, (str(ROOT), os.environ.get("PYTHONPATH")))))
    out = subprocess.run(
        [sys.executable, "-m", "lidp_tpu_torch", "-in", "in.h", "-log",
         "log.h", "-device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    log = (tmp_path / "log.h").read_text().splitlines()
    assert _min_lines(log) == _min_lines(tlog)
    assert _energy_part(_min_lines(log)) == _energy_part(_min_lines(jlog))
    assert len(_min_lines(log)) == 2


DISPLACE = FCC + """group a id 1 2 3 4 5 6 7 8 9 10 11 12 13 14 15 16 17 18
group b id 40 41 42 43 44 45 46 47 48 49 50
displace_atoms a move 3.0 -0.7 5.5 units box
displace_atoms b ramp x -0.3 0.4 y 0.5 2.5
displace_atoms all random 0.2 0.1 0.3 5531 units lattice
displace_atoms a random 0.1 0.1 0.1 77
"""


def test_displace_atoms_matches_jax():
    js, _, ts, _ = _both(DISPLACE)
    assert np.array_equal(ts.x, np.asarray(js.x))
    assert np.array_equal(ts.image, np.asarray(js.image))
    # the move crossed the faces: some image flags are not zero
    assert np.any(ts.image != 0)


def test_displace_atoms_refuses_unknown():
    ts = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    ts.execute(FCC.splitlines())
    with pytest.raises(NotImplementedError, match="displace_atoms rotate"):
        ts.one("displace_atoms all rotate 0 0 0 0 0 1 90")
    with pytest.raises(NotImplementedError, match="keywords"):
        ts.one("displace_atoms all move 1 0 0 units box extra 1")


# each minimization runs to ftol 1e-5, where cg's line search still
# resolves the energy's decrease: a secant step on the pressures of
# minimizations cut at maxiter amplifies their rounding
RELAX_MIN = ("fix 3 all box/relax iso 0.0 vmax 0.001\n"
             "minimize 0.0 1.0e-5 200 1000\n")
RELAX = {
    "3d": FCC.replace("fcc 0.8442", "fcc 1.05")
    + "displace_atoms all random 0.05 0.05 0.05 991\n" + RELAX_MIN,
    "2d": STYLES_HEAD + RELAX_MIN,
}


@pytest.mark.parametrize("dim", list(RELAX))
def test_box_relax_matches_jax(dim):
    """fix box/relax iso 0.0: the JAX package's secant loop on P around
    whole cg minimizations; the box and E_pair after it.  In 2d the
    pressure is the virial over the box volume, as the JAX package has it
    (ROADMAP queue 3)."""
    js, jlog, ts, tlog = _both(RELAX[dim])
    _same_minimum(js, jlog, ts, tlog)
    jb, tb = js._sim.sys.box, ts._sim.sys.box
    for k in ("lo", "hi"):
        want = np.asarray(getattr(jb, k))
        assert np.allclose(getattr(tb, k).numpy(), want, rtol=0,
                           atol=1e-10), k
    # the box moved
    lo0 = ts.box_lo
    assert float(np.abs(tb.lo.numpy() - lo0).max()) > 1e-6


def test_run_without_integration_fix():
    """No time-integration fix: nve with dt 0, the atoms frozen (the JAX
    package's rule), rows equal to its."""
    text = (STYLES_HEAD.replace("fix 2 all enforce2d\n", "")
            + "velocity all create 1.0 4321 loop geom\nthermo 5\nrun 20\n")
    js, _, ts, _ = _both(text)
    assert [r["step"] for r in ts.thermo_rows] == [0, 5, 10, 15, 20]
    _rows_agree(ts.thermo_rows, js.thermo_rows)
    sys_ = ts._sim.sys
    assert torch.equal(sys_.x, torch.as_tensor(ts.x))
    assert float(sys_.v.abs().max()) > 0.0


def test_min_modify_keys():
    ts = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    ts.one("min_modify dmax 0.2 line quadratic")
    assert ts._min_modify == {"dmax": 0.2}
    for bad in ("line backtrack", "alpha_damp 1.0", "dmax 0.1 norm max"):
        with pytest.raises(NotImplementedError, match="queue 3 item 11"):
            ts.one(f"min_modify {bad}")


POLAR_MIN = """min_style fire
minimize 0.0 1.0e-6 5 100
min_style cg
minimize 0.0 1.0e-6 3 100
"""
# LIDP_FAST_POLAR: the dense route, or the panel engine, whose padded
# System minimize evaluates on the dense route with the special codes
# (built up to the cap on both routes, as in the JAX package); fire's
# masses are unpadded there, in both packages, so it runs cg alone
POLAR_ROUTES = {"dense": ("0", POLAR_MIN),
                "panel": ("1", POLAR_MIN.split("min_style cg\n")[1])}


@pytest.mark.parametrize("route", list(POLAR_ROUTES))
def test_polar_fluid_minimize_matches_jax(tmp_path, monkeypatch, route):
    """minimize on the polarizable fluid (192 atoms, polar precision
    1e-11): fire then cg (cg alone on the panel engine), E_pair with
    epol, against the JAX package's."""
    env, commands = POLAR_ROUTES[route]
    monkeypatch.setenv("LIDP_FAST_POLAR", env)
    chip_smoke.fluid_script_case(str(tmp_path), n_side=4)
    text = chip_smoke.FLUID_SCRIPT.replace("run ${nstep}\n", commands)
    js, jlog, ts, tlog = _both(text, tmp_path)
    padded = ts._sim.sys.x.shape[0] > ts._sim.natoms
    assert padded == (route == "panel")
    assert len(_min_lines(tlog)) == commands.count("minimize")
    _same_minimum(js, jlog, ts, tlog)


def test_2d_above_cap(monkeypatch):
    """Above the dense cap (mocked to 40 atoms in both packages) a 2d box
    takes the cell grid with one bin along z, as in the JAX package
    (CellConfig.for_box takes a one-bin dimension): rows equal to its.
    Under 3 bins across (a 5 x 5 region, 50 atoms) the JAX package takes
    its neighbour list, and the port raises naming that item."""
    from lidp_tpu import sim as jsim
    from lidp_tpu_torch.parallel import fast_polar

    monkeypatch.setattr(jsim, "DENSE_PATH_MAX_ATOMS", 40)
    monkeypatch.setattr(fast_polar, "DENSE_PATH_MAX_ATOMS", 40)
    text = STYLES_HEAD + "fix 1 all nve\nthermo 1\nrun 3\n"
    js, _, ts, _ = _both(text)
    assert tuple(ts._sim.runner.neighbor_cfg.nbins) == (3, 3, 1)
    assert tuple(js._sim.runner.neighbor_cfg.nbins) == (3, 3, 1)
    _rows_agree(ts.thermo_rows, js.thermo_rows)
    ts = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1 item 5, neighbour lists"):
        ts.execute(text.replace("block 0 6 0 6", "block 0 5 0 5")
                   .splitlines())
