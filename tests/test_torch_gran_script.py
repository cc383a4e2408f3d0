"""The granular route of the port's front end (atom_style sphere, pair
gran/*, neigh_modify exclude group, fix gravity, freeze, nve/sphere,
nvt/sphere, wall/gran, wall/gran/region, pour and the sphere computes:
lidp_tpu_torch/styles/gran_builders.py, integrate/gran_runner.py,
sim.py) on the CPU in float64:

  * bench/in.chute's lines (chip_smoke.CHUTE_SCRIPT) on a 400-grain
    chute_layout at timestep 0.001 (the cell grid rebuilds, the shear
    migrates, the shrink-wrapped box moves), under nve/sphere and under
    nvt/sphere, and a pour of 60 grains onto a 100-grain bed with every
    sphere compute (chip_smoke.pour_bed_case), through both CLIs, the
    three JAX processes at once: every row within rel 1e-8 of max(1,
    |value|) of the JAX CLI's;
  * the LAMMPS rows of tests/test_wall_gran.py (six cases),
    tests/test_pour.py (two) and tests/test_chute.py's
    test_contact_atom_golden through the port alone, at those tests' own
    bars;
  * the sphere data file read as the JAX package reads it, and what the
    granular route refuses.
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

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
from lidp_tpu.io.data_reader import read_data as jread  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.io.data_reader import read_data as tread  # noqa: E402

ROWS = 1e-8
CHUTE = (10, 5, 8)              # 400 grains
CHUTE_STEPS, CHUTE_EVERY = 60, 10
BED, POUR, POUR_HEIGHT = (10, 10, 1), 60, 20.0
POUR_STEPS, POUR_EVERY = 100, 25
FULL = "thermo_modify	norm no format float %.15g"
NVT = "active nvt/sphere temp 1.0 1.0 0.01"


def _script(pkg, **kw):
    if pkg == "jax":
        from lidp_tpu.io.script import LammpsScript

        return LammpsScript(dtype=jnp.float64, log=lambda line: None, **kw)
    return tscript.LammpsScript(dtype=torch.float64, device="cpu",
                                log=lambda line: None, **kw)


def chute_text(nvt=False):
    """CHUTE_SCRIPT at timestep 0.001 with full-precision rows."""
    text = chip_smoke.CHUTE_SCRIPT.replace("timestep	0.0001",
                                           "timestep	0.001")
    text = text.replace("thermo_modify	norm no", FULL)
    return text.replace("active nve/sphere", NVT) if nvt else text


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        filter(None, (str(ROOT), os.environ.get("PYTHONPATH")))))


@pytest.fixture(scope="module")
def cli_rows(tmp_path_factory):
    """{case: (JAX rows, port rows, port script)}: the JAX CLI on the
    three scripts in three processes at once, the port in this process
    meanwhile."""
    d = tmp_path_factory.mktemp("gran_cli")
    chip_smoke.chute_layout(str(d / "data.chute"), *CHUTE)
    pour = chip_smoke.pour_bed_case(str(d), *BED, POUR, POUR_HEIGHT)
    cases = {"chute": (chute_text(), CHUTE_STEPS, CHUTE_EVERY),
             "chute-nvt": (chute_text(True), CHUTE_STEPS, CHUTE_EVERY),
             "pour": (pour.replace("thermo_modify norm no",
                                   FULL.replace("\t", " ")),
                      POUR_STEPS, POUR_EVERY)}
    procs = {}
    for case, (text, nstep, every) in cases.items():
        (d / f"in.{case}").write_text(text)
        procs[case] = subprocess.Popen(
            [sys.executable, "-m", "lidp_tpu", "-in", f"in.{case}", "-log",
             f"log.{case}", "-var", "nstep", str(nstep), "-var", "every",
             str(every)], cwd=d, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    port = {}
    for case, (text, nstep, every) in cases.items():
        s = _script("torch")
        s.root = str(d)
        s.variables.update(nstep=str(nstep), every=str(every))
        s.file(str(d / f"in.{case}"))
        port[case] = s
    out = {}
    for case, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (case, err[-3000:])
        out[case] = (chip_smoke.log_rows(
            (d / f"log.{case}").read_text().splitlines()),
            port[case].thermo_rows, port[case])
    return out


@pytest.mark.parametrize("case,cols", [
    ("chute", ("ke", "c_1", "vol")),
    ("chute-nvt", ("ke", "c_1", "vol")),
    ("pour", ("ke", "c_1", "c_ts", "c_es", "c_cs", "c_cm"))])
def test_cli_rows_match_jax(cli_rows, case, cols):
    jrows, trows, script = cli_rows[case]
    nstep, every = ((CHUTE_STEPS, CHUTE_EVERY) if case != "pour"
                    else (POUR_STEPS, POUR_EVERY))
    assert [int(r["step"]) for r in trows] == list(range(0, nstep + 1,
                                                         every))
    assert [r["Atoms"] for r in jrows] == [r["atoms"] for r in trows]
    chip_smoke.rows_agree(case, trows, jrows, [ROWS] * len(jrows),
                          cols=cols)
    sim = script._sim
    x0 = None if case == "pour" else tread(
        str(Path(script.root) / "data.chute"), atom_style="sphere").x
    if case == "pour":
        # one event inserts all 60 at step 1, and they land on the bed:
        # the grains' contacts, which its own spread lowers, rise
        assert [r["atoms"] for r in trows] == [100] + [160] * (len(trows)
                                                             - 1)
        assert trows[-1]["c_cs"] > trows[1]["c_cs"]
    else:
        # the grid rebuilt, the shrink-wrapped top face moved, the frozen
        # base stayed
        assert sim.istate.last_build > 0
        assert trows[-1]["vol"] != trows[0]["vol"]
        base = np.asarray(sim.script.type) == 2
        assert np.array_equal(sim.sys.x[:400].numpy()[base], x0[base])


def test_port_cli_runs_the_chute_on_the_cpu_only_when_asked(tmp_path,
                                                           monkeypatch):
    """The CLI's main (python -m lidp_tpu_torch) without -device cpu
    raises where there is no GPU; with it the chute runs and logs its
    rows."""
    from lidp_tpu_torch.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    chip_smoke.chute_layout("data.chute", *CHUTE)
    Path("in.chute").write_text(chip_smoke.CHUTE_SCRIPT)
    args = ["-in", "in.chute", "-var", "nstep", "4", "-var", "every", "2",
            "-log", "log.t"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args)
    assert main(args + ["-device", "cpu"]) == 0
    rows = chip_smoke.log_rows(Path("log.t").read_text().splitlines())
    assert [int(r["step"]) for r in rows] == [0, 2, 4]
    assert all(r["Atoms"] == 400 for r in rows)


def test_sphere_data_reads_as_jax(tmp_path):
    chip_smoke.chute_layout(str(tmp_path / "data.chute"), 4, 3, 3)
    dj = jread(str(tmp_path / "data.chute"), atom_style="sphere")
    dt = tread(str(tmp_path / "data.chute"), atom_style="sphere")
    for k in ("x", "v", "radius", "rmass", "omega", "type", "box_lo",
              "box_hi"):
        assert np.array_equal(getattr(dt, k), getattr(dj, k)), k
    assert dt.omega.any() and (dt.type == 2).sum() == 12


# ----------------------------------------------------- the LAMMPS goldens

def _wall_gen():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "gen_wallgran_goldens", ROOT / "scripts" / "gen_wallgran_goldens.py")
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    return g


@pytest.mark.parametrize("case", ["hertz", "hooke", "region", "shear",
                                  "zcyl", "zplane"])
def test_wall_gran_golden(case, tmp_path):
    """tests/test_wall_gran.py's rows through the port at its bars."""
    from test_wall_gran import FREE_FLIGHT_STEP, GOLDEN

    g = _wall_gen()
    g.write_data(str(tmp_path / "data.wallgran"))
    g.write_data(str(tmp_path / "data.wallgran2"), xyscale=0.7)
    (tmp_path / "in.case").write_text(g.make_input(case))
    s = _script("torch")
    s.root = str(tmp_path)
    s.file(str(tmp_path / "in.case"))
    got = {int(r["step"]): r for r in s.thermo_rows}
    for ref in GOLDEN[case]:
        step = int(ref[0])
        if step <= FREE_FLIGHT_STEP[case]:
            rel = 1e-9
        else:
            rel = 1e-5 * max(1.0, (step - FREE_FLIGHT_STEP[case]) / 40.0) \
                if step <= 240 else 1e-3
        for name, want in zip(("ke", "c_rot"), ref[1:]):
            assert got[step][name] == pytest.approx(want, rel=rel,
                                                    abs=1e-12), (step, name)


@pytest.mark.parametrize("case", ["one", "multi"])
def test_pour_golden(case, tmp_path):
    """tests/test_pour.py's rows through the port at its bars."""
    from test_pour import BASE, DATA, GOLDEN, POUR_LINE

    (tmp_path / "data.pour").write_text(DATA)
    pour, steps = POUR_LINE[case]
    (tmp_path / "in.pour").write_text(BASE.format(
        data=tmp_path / "data.pour", pour=pour, steps=steps))
    s = _script("torch")
    s.file(str(tmp_path / "in.pour"))
    got = {int(r["step"]): r for r in s.thermo_rows}
    for ref in GOLDEN[case]:
        r = got[int(ref[0])]
        assert r["atoms"] == int(ref[1])
        rel = 1e-9 if (case == "one" or ref[0] < 575) else 1e-4
        for name, want in zip(("ke", "c_rot"), ref[2:]):
            assert r[name] == pytest.approx(want, rel=rel, abs=1e-12)


def test_contact_atom_golden(tmp_path):
    """tests/test_chute.py's six-sphere chain: reduce sum 6, max 2."""
    from test_chute import CONTACT_DATA

    (tmp_path / "data.spheres").write_text(CONTACT_DATA)
    s = _script("torch")
    s.root = str(tmp_path)
    s.execute("""units lj
atom_style sphere
boundary p p p
newton off
comm_modify vel yes
read_data data.spheres
pair_style gran/hooke/history 200000.0 NULL 50.0 NULL 0.5 0
pair_coeff * *
neighbor 0.1 bin
fix 3 all nve/sphere
compute ca all contact/atom
compute re all reduce sum c_ca
compute rm all reduce max c_ca
thermo_style custom step c_re c_rm
thermo_modify norm no
run 0""".splitlines())
    row = s.thermo_rows[0]
    assert row["c_re"] == 6.0 and row["c_rm"] == 2.0


# ----------------------------------------------------- what still raises

SPHERE = """units lj
atom_style sphere
boundary p p p
read_data data.spheres
"""
ATOMIC = """units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 3 0 3 0 3
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
fix 1 all nve
"""
REFUSED = {
    "gran on atomic data": (
        ATOMIC + "pair_style gran/hooke 2000.0 NULL 50.0 NULL 0.5 0\n"
        "pair_coeff * *\nrun 0", ValueError,
        "requires atom_style sphere data"),
    "fix gravity without gran": (
        ATOMIC + "fix g all gravity 1.0 vector 0 0 -1\nrun 0",
        NotImplementedError, "pair gran"),
    "nvt/sphere without gran": (
        ATOMIC.replace("fix 1 all nve", "fix 1 all nvt/sphere temp 1 1 1")
        + "run 0", NotImplementedError, "item 6.8"),
    "npt/sphere": (ATOMIC + "fix 2 all npt/sphere temp 1 1 1 iso 1 1 1",
                   NotImplementedError, "item 6.8"),
    "exclude group without gran": (
        ATOMIC + "neigh_modify exclude group all all\nrun 0",
        NotImplementedError, "queue 3 item 44"),
    "erotate/sphere without gran": (
        ATOMIC + "compute e all erotate/sphere\nrun 0", NotImplementedError,
        "queue 3 item 26"),
    "exclude group A B": (ATOMIC + "group a id 1 2\nneigh_modify exclude "
                          "group all a", NotImplementedError, "item 6"),
    "compute temp on granular": (
        SPHERE + "pair_style gran/hooke 2000.0 NULL 50.0 NULL 0.5 0\n"
        "pair_coeff * *\nfix 1 all nve/sphere\ncompute t all temp\nrun 0",
        NotImplementedError, "queue 3 item 26"),
    "gran keyword after the six settings": (
        SPHERE + "pair_style gran/hooke/history 2000.0 NULL 50.0 NULL 0.5 0 "
        "limit_damping\npair_coeff * *\nrun 0", NotImplementedError,
        "queue 3 item 25"),
    "fix nve on granular": (
        SPHERE + "pair_style gran/hooke 2000.0 NULL 50.0 NULL 0.5 0\n"
        "pair_coeff * *\nfix 1 all nve\nrun 0", NotImplementedError,
        "granular systems"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refusals(name, tmp_path):
    from test_chute import CONTACT_DATA

    (tmp_path / "data.spheres").write_text(CONTACT_DATA)
    text, exc, match = REFUSED[name]
    s = _script("torch")
    s.root = str(tmp_path)
    with pytest.raises(exc, match=match):
        s.execute(text.splitlines())
