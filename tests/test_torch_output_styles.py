"""The port's output styles (lidp_tpu_torch/io/dump.py, io/script.py,
styles/fix_output.py): the local computes with dump local, fix
store/state and fix controller with variable internal, the xyz, dcd,
cfg, image and movie dumps, read_dump and rerun, on the CPU in float64:

  * four scripts through the JAX CLI (the four processes at once) and the
    port (in this process meanwhile): a 108-atom LJ melt with every one of
    them, read_dump and rerun of its own custom dump; 32 bonded molecules
    as rigid bodies with bond/local, angle/local, dihedral/local,
    improper/local, property/local's bond columns and rigid/local; the
    375-atom polar fluid with pair/local and property/local's pair and
    neighbour columns over its special bonds, then rerun and read_dump of
    its custom dump, on the dense route and on the panel route
    (LIDP_FAST_POLAR=1).  The thermo rows within rel 1e-8 of max(1,
    |value|) of the JAX CLI's; every dump file the same text or, where a
    printed number differs, within rel 1e-8 of JAX's; dcd and PPM files
    byte for byte;
  * the pair/local rows formed on the device from the cell candidates in
    (i, j) order, against an independent O(N^2) count;
  * the LAMMPS rows of the JAX package's tests of these styles through the
    port, at those tests' bars;
  * what the port refuses, each naming its ROADMAP item.
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
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402

REL = 1e-8
FULL = "thermo_modify format float %.15g\n"

LJ_HEAD = """units lj
atom_style atomic
boundary p p p
lattice fcc 0.8442
region box block 0 3 0 3 0 3
create_box 1 box
create_atoms 1 box
mass 1 1.0
velocity all create 1.44 87287 loop geom
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0
"""
LJ = LJ_HEAD + """fix 1 all nve
variable tcv internal 0.0
compute tt all temp
fix pid all controller 2 1.0 0.5 0.1 0.05 c_tt 1.2 tcv
compute ka all ke/atom
fix s0 all store/state 0 x y z vx
fix s1 all store/state 2 c_ka
compute pl all pair/local dist eng force fx fy fz p1 p2
compute pp all property/local patom1 patom2 ptype1 ptype2
compute pn all property/local natom1 natom2 ntype1 ntype2
dump 1 all local 2 lj.local index c_pl[1] c_pl[2] c_pl[3] c_pl[4] \
c_pl[5] c_pl[6] c_pl[7] c_pl[8] c_pp[1] c_pp[2] c_pp[3] c_pp[4]
dump 2 all local 3 lj.nlocal c_pn[1] c_pn[2] c_pn[3] c_pn[4]
dump 3 all xyz 2 lj.xyz
dump 4 all dcd 2 lj.dcd
dump 5 all cfg 2 lj.cfg mass type xs ys zs vx vy vz q id
dump 6 all image 6 lj.*.ppm type type size 100 80 zoom 1.3 view 70 20
dump 7 all movie 3 lj.mpg type type adiam 0.9
dump 8 all custom 2 lj.state id f_s0[1] f_s0[2] f_s0[4] f_s1
dump 9 all custom 2 lj.dump id type x y z vx vy vz
dump_modify 9 sort id format float %.17g
thermo 2
thermo_style custom step temp pe press v_tcv c_tt
""" + FULL + """run 6
undump 1
undump 2
undump 3
undump 4
undump 5
undump 6
undump 7
undump 8
undump 9
rerun lj.dump first 2 every 2 dump x y z vx vy vz
read_dump lj.dump 4 x y z vx vy vz
run 0
"""
LJ_FILES = ("lj.local", "lj.nlocal", "lj.xyz", "lj.dcd", "lj.cfg",
            "lj.0.ppm", "lj.6.ppm", "lj.mpg.000000.ppm", "lj.mpg.000002.ppm",
            "lj.state", "lj.dump")
MOLEC = """units lj
atom_style full
read_data data.bonded
pair_style lj/cut 2.0
pair_coeff * * 0.2 1.0
special_bonds lj 0.0 0.5 1.0
bond_style harmonic
bond_coeff * 40.0 1.0
angle_style harmonic
angle_coeff 1 30.0 109.5
angle_coeff 2 40.0 115.0
dihedral_style opls
dihedral_coeff * 1.3 -0.05 0.2 0.0
improper_style harmonic
improper_coeff * 5.0 10.0
velocity all create 0.3 4928459 loop geom
fix 1 all rigid/nve molecule
compute aa all angle/local theta eng
compute dd all dihedral/local phi
compute ii all improper/local chi
compute bb all bond/local dist engpot force
compute pb all property/local batom1 batom2 btype
compute rl all rigid/local 1 id mol mass x y z xu yu zu ix iy iz vx vy \
vz fx fy fz omegax omegay omegaz angmomx angmomy angmomz tqx tqy tqz \
quatw quati quatj quatk inertiax inertiay inertiaz
dump 1 all local 2 m.angle index c_aa[1] c_aa[2]
dump 2 all local 2 m.torsion index c_dd[1] c_ii[1]
dump 3 all local 2 m.bond index c_bb[1] c_bb[2] c_bb[3] c_pb[1] c_pb[2] \
c_pb[3]
dump 4 all local 2 m.rigid index c_rl[1] c_rl[2] c_rl[3] c_rl[4] c_rl[5] \
c_rl[6] c_rl[7] c_rl[8] c_rl[9] c_rl[10] c_rl[11] c_rl[12] c_rl[13] \
c_rl[14] c_rl[15] c_rl[16] c_rl[17] c_rl[18] c_rl[19] c_rl[20] c_rl[21] \
c_rl[22] c_rl[23] c_rl[24] c_rl[25] c_rl[26] c_rl[27] c_rl[28] c_rl[29] \
c_rl[30] c_rl[31] c_rl[32] c_rl[33] c_rl[34]
thermo 2
""" + FULL + "run 4\n"
MOLEC_FILES = ("m.angle", "m.torsion", "m.bond", "m.rigid")
FLUID_OUT = """\
dump d all custom 1 fluid.dump id type x y z vx vy vz
dump_modify d sort id format float %.17g
compute pl all pair/local dist eng force fx fy fz p1 p2
compute pp all property/local patom1 patom2 ptype1 ptype2
compute pn all property/local natom1 natom2
dump l all local 2 fl.local index c_pl[1] c_pl[2] c_pl[3] c_pl[4] \
c_pl[5] c_pl[6] c_pl[7] c_pl[8] c_pp[1] c_pp[2] c_pp[3] c_pp[4]
dump n all local 2 fl.nlocal c_pn[1] c_pn[2]
""" + FULL + """run ${nstep}
undump d
undump l
undump n
rerun fluid.dump dump x y z vx vy vz
read_dump fluid.dump 1 x y z vx vy vz
run 0
"""
FLUID_FILES = ("fl.local", "fl.nlocal", "fluid.dump")
FLUID_STEPS = 2
# case: (input, files compared, environment)
CASES = {
    "lj": ("in.lj", LJ_FILES, {}),
    "molec": ("in.molec", MOLEC_FILES, {}),
    "fluid": ("in.fluid", FLUID_FILES, {}),
    "fluid_panel": ("in.fluid", FLUID_FILES, {"LIDP_FAST_POLAR": "1"}),
}


def _env(extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, (
                   str(ROOT), os.environ.get("PYTHONPATH")))))
    env.pop("LIDP_FAST_POLAR", None)
    env.update(extra)
    return env


def _inputs(d, case):
    """Write case's input and data into directory d."""
    if case == "lj":
        (d / "in.lj").write_text(LJ)
    elif case == "molec":
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "gen_bonded_goldens", ROOT / "scripts" / "gen_bonded_goldens.py")
        gen = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(gen)
        gen.write_data(str(d / "data.bonded"))
        (d / "in.molec").write_text(MOLEC)
    else:
        chip_smoke.fluid_script_case(str(d), n_side=5)
        (d / "in.fluid").write_text(chip_smoke.FLUID_SCRIPT.replace(
            "run ${nstep}", FLUID_OUT))


def _port(d, name, env):
    s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                             log=lambda line: None)
    s.variables["nstep"] = str(FLUID_STEPS)
    with mock.patch.dict(os.environ, _env(env)):
        s.file(str(d / name))
    return s


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (JAX CLI rows, port script, JAX directory, port
    directory)}: the JAX CLI on the four inputs in four processes at once,
    the port in this process meanwhile, each run in a directory of its
    own."""
    procs, dirs = {}, {}
    for case, (name, _, env) in CASES.items():
        dj = tmp_path_factory.mktemp(f"{case}_jax")
        dt = tmp_path_factory.mktemp(f"{case}_torch")
        for d in (dj, dt):
            _inputs(d, case)
        dirs[case] = (dj, dt)
        procs[case] = subprocess.Popen(
            [sys.executable, "-m", "lidp_tpu", "-in", name, "-log", "log",
             "-var", "nstep", str(FLUID_STEPS)], cwd=dj, env=_env(env),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = {case: _port(dirs[case][1], name, env)
            for case, (name, _, env) in CASES.items()}
    out = {}
    for case, proc in procs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, (case, err[-3000:])
        dj, dt = dirs[case]
        out[case] = (chip_smoke.log_rows((dj / "log").read_text()
                                         .splitlines()),
                     port[case], dj, dt)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_rows_match_jax(runs, case):
    jrows, s, _, _ = runs[case]
    trows = s.thermo_rows
    assert [int(r["step"]) for r in jrows] == [r["step"] for r in trows]
    cols = [c for c in jrows[0] if c != "step"]
    chip_smoke.rows_agree(case, trows, jrows, [REL] * len(jrows), cols)


def _numbers_close(a, b):
    """Two files' text: the same words, or numbers within REL of max(1,
    |JAX's|)."""
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x == y:
            continue
        wx, wy = x.split(), y.split()
        assert len(wx) == len(wy), (x, y)
        for u, v in zip(wx, wy):
            if u != v:
                assert abs(float(u) - float(v)) <= REL * max(
                    1.0, abs(float(v))), (x, y)


@pytest.mark.parametrize("case,name", [
    (case, name) for case, (_, files, _) in CASES.items() for name in files])
def test_files_match_jax(runs, case, name):
    _, _, dj, dt = runs[case]
    a, b = (dt / name).read_bytes(), (dj / name).read_bytes()
    if name.endswith((".dcd", ".ppm")):
        assert a == b
    else:
        _numbers_close(a.decode(), b.decode())


def test_rerun_and_read_dump_rows(runs):
    """Each rerun frame's and read_dump's energies are the run's at that
    step (the frames carry x and v at %.17g), on both polar routes and
    the melt."""
    for case, cols in (("fluid", ("pe", "evdwl", "ecoul", "elong", "epol",
                                  "ke")),
                       ("fluid_panel", ("pe", "evdwl", "ecoul", "elong",
                                        "epol", "ke")),
                       ("lj", ("temp", "pe"))):
        s = runs[case][1]
        rows = s.thermo_rows
        nrun = (FLUID_STEPS + 1) if case.startswith("fluid") else 4
        run, rest = rows[:nrun], rows[nrun:]
        bystep = {r["step"]: r for r in run}
        chip_smoke.rows_agree(case, rest, [bystep[r["step"]] for r in rest],
                              [1e-9] * len(rest), cols)
        assert len(s.rerun_timings) == (FLUID_STEPS + 1
                                        if case.startswith("fluid") else 3)
    panel = runs["fluid_panel"][1]._sim.runner
    assert type(panel).__name__ == "FastPolarRunner"
    assert runs["fluid"][1]._sim.runner.neighbor_cfg is None


def test_local_pairs_in_order(runs):
    """pair/local's rows: every i < j pair inside the cutoff once, in
    (i, j) order, against a dense count of the same positions; on the
    fluid the special pairs of weight 0 left out (its O-H bonds)."""
    s = runs["fluid"][1]
    sim = s._sim
    from lidp_tpu_torch.io import dump as tdump

    i, j, rsq, d, fl, fc = tdump.local_pairs(sim, s.groups["all"])
    n = sim.natoms
    key = (i * n + j).numpy()
    assert (np.diff(key) > 0).all() and (i < j).all()
    x = sim.sys.x[:n].double().numpy()
    L = sim.sys.box.lengths.double().numpy()
    dd = x[:, None, :] - x[None, :, :]
    dd -= L * np.round(dd / L)
    r2 = (dd * dd).sum(-1)
    code = sim.runner.ff.sp_code.numpy()[:n, :n]
    cut = float(sim.runner.ff.pair.cutsq.max())
    want = np.triu((r2 < cut) & (code == 0), 1)
    assert np.array_equal(np.argwhere(want), torch.stack([i, j], 1).numpy())
    assert fl is not None and bool((fl == 1.0).all())


def _port_text(tmp_path, text, name="in.case"):
    (tmp_path / name).write_text(text)
    s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                             log=lambda line: None)
    s.file(str(tmp_path / name))
    return s


def _read_local(path):
    rows, grab = [], False
    for ln in open(path).read().splitlines():
        if ln.startswith("ITEM: ENTRIES"):
            grab = True
            continue
        if ln.startswith("ITEM: TIMESTEP"):
            grab = False
        if grab and ln.strip():
            rows.append([float(v) for v in ln.split()])
    return np.array(rows)


def test_controller_golden(tmp_path):
    """tests/test_controller_molecule.py::test_controller_golden's LAMMPS
    rows through the port."""
    from tests.test_controller_molecule import CTRL_GOLDEN

    s = _port_text(tmp_path, LJ_HEAD + """fix 1 all nve
variable tcv internal 0.0
compute tt all temp
fix pid all controller 2 1.0 0.5 0.1 0.05 c_tt 1.2 tcv
thermo 2
thermo_style custom step temp v_tcv
run 6
""")
    rows = {r["step"]: r for r in s.thermo_rows}
    for step, t, cv in CTRL_GOLDEN:
        assert rows[step]["temp"] == pytest.approx(t, rel=1e-10)
        assert rows[step]["v_tcv"] == pytest.approx(cv, rel=1e-9, abs=1e-15)


def test_dump_local_goldens(tmp_path):
    """tests/test_dump_local_image.py's LAMMPS rows of pair/local (the
    64-atom breadth box: count, column sums, first and last rows) and
    bond/local's analytic values, dump image's PPM and dump movie's
    frames, through the port."""
    from scripts.gen_breadth_goldens import write_data
    from tests import test_dump_local_image as g

    write_data(str(tmp_path / "data.breadth"))
    head = f"""units lj
atom_style charge
read_data {tmp_path}/data.breadth
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0
pair_coeff 2 2 0.8 1.1
"""
    _port_text(tmp_path, head + f"""compute 1 all pair/local dist eng force
dump 1 all local 1 {tmp_path}/dump.plocal index c_1[1] c_1[2] c_1[3]
dump 2 all image 1 {tmp_path}/img.*.ppm type type size 200 160 zoom 1.2
run 0
""")
    r = _read_local(tmp_path / "dump.plocal")[:, 1:]
    assert len(r) == g.REF_COUNT
    r = r[np.lexsort((r[:, 1], r[:, 0]))]
    for got, ref in zip(r.sum(0), g.REF_SUMS):
        assert got == pytest.approx(ref, rel=1e-6, abs=1e-6)
    np.testing.assert_allclose(r[0], g.REF_FIRST, rtol=2e-5)
    np.testing.assert_allclose(r[-1], g.REF_LAST, rtol=2e-5)
    raw = (tmp_path / "img.0.ppm").read_bytes()
    assert raw.startswith(b"P6\n200 160\n255\n")
    px = np.frombuffer(raw[len(b"P6\n200 160\n255\n"):], np.uint8)
    px = px.reshape(160, 200, 3)
    assert 500 < np.count_nonzero(px.sum(-1) > 0) < 200 * 160
    assert np.count_nonzero((px[..., 0] > 100) & (px[..., 2] < 50)) > 50
    assert np.count_nonzero((px[..., 2] > 100) & (px[..., 0] < 50)) > 50
    (tmp_path / "data.tiny").write_text("""tiny bonded box

4 atoms
1 atom types
2 bonds
1 bond types

0 10 xlo xhi
0 10 ylo yhi
0 10 zlo zhi

Masses

1 1.0

Atoms

1 1 1 0.0 2.0 2.0 2.0
2 1 1 0.0 3.2 2.0 2.0
3 1 1 0.0 5.0 5.0 5.0
4 1 1 0.0 5.0 6.5 5.0

Bonds

1 1 1 2
2 1 3 4
""")
    _port_text(tmp_path, f"""units lj
atom_style full
read_data {tmp_path}/data.tiny
bond_style harmonic
bond_coeff 1 10.0 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 0.0 1.0
special_bonds lj 0 1 1
compute 1 all bond/local dist engpot
dump 1 all local 1 {tmp_path}/dump.blocal index c_1[1] c_1[2]
run 0
""", "in.bond")
    r = _read_local(tmp_path / "dump.blocal")[:, 1:]
    r = r[np.argsort(r[:, 0])]
    np.testing.assert_allclose(r[0], [1.2, 10.0 * 0.04], rtol=1e-10)
    np.testing.assert_allclose(r[1], [1.5, 10.0 * 0.25], rtol=1e-10)
    _port_text(tmp_path, """units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 2 0 2 0 2
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0
fix 1 all nve
dump mv all movie 2 out.mpg type type zoom 1.6
run 4
""", "in.mv")
    frames = sorted(tmp_path.glob("out.mpg.*.ppm"))
    assert len(frames) == 3 and frames[0].read_bytes()[:2] == b"P6"


def test_rerun_read_dump_goldens(tmp_path):
    """tests/test_misc_commands2.py's rerun and read_dump LAMMPS rows."""
    from tests import test_misc_commands2 as g

    _port_text(tmp_path, g.RERUN_HEAD + """neighbor 0.3 bin
fix 1 all nve
dump d1 all custom 2 melt.dump id type x y z vx vy vz
dump_modify d1 sort id format float %.15g
run 6
""", "in.mk")
    s = _port_text(tmp_path, g.MELT_HEAD + """neighbor 0.3 bin
thermo 2
thermo_style custom step temp pe press
rerun melt.dump dump x y z vx vy vz
""", "in.rr")
    rows = {r["step"]: r for r in s.thermo_rows}
    for step, temp, pe, press in g.RERUN_GOLDEN:
        assert rows[step]["temp"] == pytest.approx(temp, rel=1e-8)
        assert rows[step]["pe"] == pytest.approx(pe, rel=1e-8)
        assert rows[step]["press"] == pytest.approx(press, rel=1e-7)
    s = _port_text(tmp_path, g.MELT_HEAD + """neighbor 0.3 bin
thermo_style custom step temp pe press
read_dump melt.dump 4 x y z vx vy vz
run 0
""", "in.rd")
    row = s.thermo_rows[-1]
    assert row["step"] == 4
    assert row["temp"] == pytest.approx(1.40164128098, rel=1e-8)
    assert row["pe"] == pytest.approx(-6.71630169257, rel=1e-8)


def test_observability_goldens(tmp_path):
    """tests/test_observability_breadth.py's angle, dihedral and improper
    local computes, dump cfg and the rigid computes with rigid/local,
    through the port at that file's bars."""
    import importlib.util

    from tests.test_observability_breadth import MOLEC as HEAD

    spec = importlib.util.spec_from_file_location(
        "gen_bonded_goldens", ROOT / "scripts" / "gen_bonded_goldens.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    gen.write_data(str(tmp_path / "data.bonded"))
    _port_text(tmp_path, HEAD + """compute aa all angle/local theta eng
compute dd all dihedral/local phi
compute ii all improper/local chi
dump 1 all local 1 ang.dump index c_aa[1] c_aa[2]
dump 2 all local 1 tor.dump index c_dd[1] c_ii[1]
dump 3 all cfg 1 conf.cfg mass type xs ys zs q
run 0
""")
    body = _read_local(tmp_path / "ang.dump")
    assert body.shape[0] == 16
    theta = body[:, 1]
    assert (theta > 60).all() and (theta < 180).all()
    co = {1: (30.0, 109.5), 2: (40.0, 115.0)}
    at = np.array([1, 2] * 8)
    expect = np.array([co[t][0] for t in at]) * np.deg2rad(
        theta - np.array([co[t][1] for t in at])) ** 2
    np.testing.assert_allclose(body[:, 2], expect, rtol=3e-5)
    tor = _read_local(tmp_path / "tor.dump")
    assert tor.shape[0] == 8 and (np.abs(tor[:, 1:]) <= 180.0).all()
    text = (tmp_path / "conf.cfg").read_text()
    assert text.startswith("Number of particles = 32")
    assert "H0(1,1) = 12 A" in text and "auxiliary[0] = q" in text
    arr = np.array([[float(v) for v in ln.split()] for ln in
                    text.splitlines() if len(ln.split()) == 4
                    and not ln.startswith(("H0", "A ="))])
    assert ((arr[:, :3] >= 0) & (arr[:, :3] < 1)).all()
    s = _port_text(tmp_path, HEAD + """velocity all create 0.3 4928459 loop geom
fix 1 all rigid/nve molecule
compute tke all ke/rigid 1
compute ter all erotate/rigid 1
compute rl all rigid/local 1 id mol mass xu omegax quatw inertiax
dump 3 all local 2 rb.dump index c_rl[2] c_rl[3] c_rl[6]
thermo_style custom step ke c_tke c_ter
thermo 2
run 4
""", "in.rigid")
    for row in s.thermo_rows:
        assert row["c_tke"] > 0 and row["c_ter"] > 0
        np.testing.assert_allclose(row["c_tke"] + row["c_ter"], row["ke"],
                                   rtol=1e-9)
    rows = [ln.split() for ln in
            (tmp_path / "rb.dump").read_text().splitlines()]
    hdr = max(i for i, r in enumerate(rows) if r[:2] == ["ITEM:", "ENTRIES"])
    assert rows[hdr][2:] == ["index", "c_rl[2]", "c_rl[3]", "c_rl[6]"]
    body = np.array([[float(v) for v in r] for r in rows[hdr + 1:]])
    assert body.shape[0] == 8
    np.testing.assert_allclose(body[:, 2], body[0, 2])
    assert body[0, 2] > 0 and set(body[:, 1].astype(int)) == set(range(1, 9))
    assert (np.abs(body[:, 3]) <= 1.0 + 1e-12).all()


def test_xyz_dcd_store_state_goldens(tmp_path):
    """tests/test_units_xyz.py's dump xyz and dcd layouts and
    tests/test_data_collection.py's store/state snapshot, through the
    port."""
    import struct

    head = LJ_HEAD.replace("0 3 0 3 0 3", "0 2 0 2 0 2").replace(
        "velocity all create 1.44 87287 loop geom\n", "") + "fix 1 all nve\n"
    _port_text(tmp_path, head + """dump d1 all xyz 1 traj.xyz
dump d2 all dcd 1 traj.dcd
run 2
""")
    lines = (tmp_path / "traj.xyz").read_text().splitlines()
    assert lines[0] == "32" and lines[1].startswith("Atoms. Timestep:")
    row = lines[2].split()
    assert row[0] == "1" and len(row) == 4 and len(lines) == 3 * 34
    raw = (tmp_path / "traj.dcd").read_bytes()
    off = 0

    def rec():
        nonlocal off
        n = struct.unpack_from("<i", raw, off)[0]
        assert struct.unpack_from("<i", raw, off + 4 + n)[0] == n
        payload = raw[off + 4:off + 4 + n]
        off += 8 + n
        return payload

    hdr = rec()
    assert len(hdr) == 84 and hdr[:4] == b"CORD"
    rec()
    assert struct.unpack("<i", rec())[0] == 32
    for _ in range(3):
        a, cg, b, cb, ca, c = struct.unpack("<6d", rec())
        assert a > 3.0 and b == a and c == a
        for _ in range(3):
            xs = np.frombuffer(rec(), "<f4")
            assert xs.shape == (32,) and np.isfinite(xs).all()
    assert off == len(raw)
    s = _port_text(tmp_path, LJ_HEAD.replace("0 3 0 3 0 3", "0 4 0 4 0 4")
                   + """fix 1 all nve
fix s0 all store/state 0 x y z
fix av all ave/atom 1 4 4 vx
dump 1 all custom 4 st.dump id f_s0[1] f_av
run 4
""", "in.st")
    last = (tmp_path / "st.dump").read_text().split("ITEM: TIMESTEP")[-1]
    rows = np.array([[float(v) for v in ln.split()] for ln in
                     last.splitlines()[9:] if ln.strip()])
    np.testing.assert_allclose(rows[:, 1], np.asarray(s.x)[:, 0],
                               rtol=1e-5, atol=1e-5)
    assert np.isfinite(rows[:, 2]).all() and np.abs(rows[:, 2]).max() < 10.0


REFUSALS = {
    "tilted read_dump": (None, "item 6.4"),
    # atom- and world-style variables are ported (tests/
    # test_torch_molecule_bonds.py): an atom-style dump column and the
    # universe style still raise
    "variable atom": ("dump 8 all custom 1 v.dump id v_a", "queue 1 item 6"),
    "variable world": ("variable a universe 1 2", "queue 1 item 4"),
    "variable file": ("variable a file f.txt", "queue 1 item 4"),
    "variable python": ("variable a python f", "queue 1 item 4"),
    "read_dump keyword": ("read_dump lj.dump 2 x y z box no",
                          "queue 3 item 25"),
    "rerun start": ("rerun lj.dump start 0 dump x y z", "queue 3 item 25"),
    "image keyword": ("dump i all image 1 i.ppm type type shiny 0.5",
                      "queue 3 item 25"),
    "image attributes": ("dump i all image 1 i.ppm element type",
                         "queue 3 item 25"),
    "store/state com": ("fix s all store/state 0 x com yes",
                        "queue 3 item 25"),
    "controller on a fix": ("fix c all controller 1 1 1 1 1 f_x 1.0 tcv",
                            "queue 3 item 26"),
    "pair/local cutoff": ("compute p all pair/local dist cutoff type",
                          "queue 3 item 25"),
    "pair/local exclude": (None, "queue 3 item 49"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals(tmp_path, name):
    line, item = REFUSALS[name]
    s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                             log=lambda line: None)
    s.root = str(tmp_path)
    s.execute((LJ_HEAD + "fix 1 all nve\nvariable tcv internal 0\n"
               "dump 9 all custom 2 lj.dump id type x y z\n"
               "run 2\n").splitlines())
    if name == "tilted read_dump":
        (tmp_path / "tilt.dump").write_text(
            "ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n1\n"
            "ITEM: BOX BOUNDS xy xz yz pp pp pp\n0 5 0.5\n0 5 0\n0 5 0\n"
            "ITEM: ATOMS id x y z\n1 1 1 1\n")
        line = "read_dump tilt.dump 0 x y z"
    elif name == "pair/local exclude":
        s.one("neigh_modify exclude type 1 1")
        line = "compute p all pair/local dist"
    with pytest.raises(NotImplementedError, match=item):
        s.one(line)


def test_local_computes_need_a_rigid_fix_and_values(tmp_path):
    """rigid/local without a rigid integrator and dump local over a
    compute that is not local raise ValueError, as in the JAX package."""
    s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                             log=lambda line: None)
    s.root = str(tmp_path)
    s.execute((LJ_HEAD + "fix 1 all nve\n"
               "compute rl all rigid/local 1 id mass\n"
               "dump 1 all local 1 r.dump index c_rl[1]\n").splitlines())
    with pytest.raises(ValueError, match="rigid fix"):
        s.one("run 0")
    with pytest.raises(ValueError, match="not a local compute"):
        s.one("dump 2 all local 1 t.dump index c_thermo_temp")
