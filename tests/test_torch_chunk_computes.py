"""The port's chunk computes (lidp_tpu_torch/computes.py chunk_ids,
ChunkTable, eval_chunk_agg; styles/fix_output.py ave_chunk, global_array,
ave/time mode vector; io/script.py's chunk/atom and */chunk grammar)
against LAMMPS and the JAX package, float64 on the CPU:

  * tests/test_chunk_computes.py's 14 CHUNK_GOLDEN cases (the 11 */chunk
    styles on type, bin/1d and bin/2d chunks through fix ave/time mode
    vector) and its two SCALAR_GOLDEN rows (temp/chunk's scalar), all in
    one script per package: each case's file within 5e-5 of the column
    scale of LAMMPS's rows, the scalars within 1e-9 (that test's bars);
    each file equal to JAX's character for character (same_text: but for
    step 0's torque, cancellation noise), its values and the rows within
    rel 1e-10 of JAX's;
  * fix ave/chunk on bin/1d (reduced, lower; lattice, a numeric origin),
    bin/2d (box, center), bin/3d and type chunks with every value it takes
    and a file, Nrepeat*Nevery both equal to and below Nfreq: the files
    equal to JAX's and ave_chunk_values within rel 1e-10;
    tests/test_ave_chunk.py's two analytic profiles;
  * molecule chunks on bead-spring chains written from a seed
    (chip_smoke.chain_script_case), every */chunk style by molecule and
    fix ave/chunk by molecule, against JAX; the chunk ids against JAX's
    _chunk_ids exactly; a dump of c_ID of a chunk/atom compute;
  * `python -m lidp_tpu_torch -in` on the molecule script;
  * what the JAX package skips raises NotImplementedError naming ROADMAP
    queue 3 item 25 (chunk/atom's keywords, fix ave/chunk's), and what it
    refuses raises its ValueError (bin/sphere, bin/cylinder, an unknown
    chunk style).
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch import computes as tcomputes  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
REL = 1e-10


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _load("test_chunk_computes")      # HEAD, CASES, goldens, _read_frames


def _script(pkg, root, log=None):
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64,
                                 log=log or (lambda line: None))
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                                 log=log or (lambda line: None))
    s.root = str(root)
    return s


def _both(tmp_path_factory, name, text, setup=None):
    """text through both packages, each in a directory of its own (setup
    writes its inputs there first): {pkg: (script, directory)}."""
    out = {}
    for pkg in ("jax", "torch"):
        work = tmp_path_factory.mktemp(f"{name}_{pkg}")
        if setup is not None:
            setup(str(work))
        s = _script(pkg, work)
        s.execute(text.splitlines())
        out[pkg] = (s, work)
    return out


def _golden_text():
    """Every CHUNK_GOLDEN and SCALAR_GOLDEN case in one script: case c's
    computes and fix renamed by c, its file out_c.txt."""
    body = ""
    for case in sorted(G.CHUNK_GOLDEN):
        body += (G.CASES[case].replace("compute g ", f"compute g_{case} ")
                 .replace("compute cb ", f"compute cb_{case} ")
                 .replace(" cb\n", f" cb_{case}\n")
                 .replace(" cb temp\n", f" cb_{case} temp\n")
                 .replace("c_g ", f"c_g_{case} ")
                 .replace("fix av ", f"fix av_{case} ")
                 .replace("out.txt", f"out_{case}.txt"))
    scalars = sorted(G.SCALAR_GOLDEN)
    for case in scalars:
        line = G.SCALAR_CASES[case].splitlines()[0]
        body += line.replace("compute g ", f"compute g_{case} ") + "\n"
    body += "thermo_style custom step temp " + " ".join(
        f"c_g_{case}" for case in scalars) + "\n"
    return G.HEAD + body + G.TAIL


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return _both(tmp_path_factory, "golden", _golden_text())


def _file_text(work, name):
    with open(os.path.join(str(work), name)) as fh:
        return fh.read()


def same_text(got, want):
    """got equal to want character for character, but for a number that is
    cancellation noise in both (a step-0 torque of a fresh lattice, ~1e-14,
    the sum of forces whose last bits differ between the packages): there
    the two numbers are within REL of the largest magnitude of their
    column (the same token position on lines of the same length) over the
    file.  Returns the count of such numbers."""
    a, b = got.splitlines(), want.splitlines()
    assert len(a) == len(b)
    scale = {}
    for line in b:
        for k, tok in enumerate(line.split()):
            try:
                v = abs(float(tok))
            except ValueError:
                continue
            key = (len(line.split()), k)
            scale[key] = max(scale.get(key, 0.0), v)
    noise = 0
    for la, lb in zip(a, b):
        if la == lb:
            continue
        ta, tb = la.split(), lb.split()
        assert len(ta) == len(tb), (la, lb)
        for k, (x, y) in enumerate(zip(ta, tb)):
            if x != y:
                bar = REL * scale[(len(tb), k)]
                assert abs(float(x)) <= bar and abs(float(y)) <= bar, (la, lb)
                noise += 1
    return noise


@pytest.mark.parametrize("case", sorted(G.CHUNK_GOLDEN))
def test_chunk_compute_golden(golden, case):
    """The case's frames at tests/test_chunk_computes.py's bar against
    LAMMPS; its file equal to JAX's."""
    (js, jwork), (ts, twork) = golden["jax"], golden["torch"]
    name = f"out_{case}.txt"
    same_text(_file_text(twork, name), _file_text(jwork, name))
    got = G._read_frames(os.path.join(str(twork), name))
    want = G.CHUNK_GOLDEN[case]
    assert sorted(got) == sorted(want)
    for step, rows in want.items():
        g, w = np.asarray(got[step]), np.asarray(rows)
        assert g.shape == w.shape, (case, step)
        if np.abs(w).max() < 1e-9:
            assert np.abs(g).max() < 1e-9, (case, step)
            continue
        scale = np.maximum(np.abs(w).max(axis=0, keepdims=True),
                           1e-6 * np.abs(w).max())
        assert (np.abs(g - w) / scale).max() < 5e-5, (case, step)
    # the averaged arrays themselves (ave_time_values) against JAX's
    jv = js.ave_time_values[f"av_{case}"]
    tv = ts.ave_time_values[f"av_{case}"]
    assert [s for s, _ in tv] == [s for s, _ in jv]
    for (_, a), (_, b) in zip(tv, jv):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= REL * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("case", sorted(G.SCALAR_GOLDEN))
def test_temp_chunk_scalar_golden(golden, case):
    js, ts = golden["jax"][0], golden["torch"][0]
    rows = {int(r["step"]): r for r in ts.thermo_rows}
    jrows = {int(r["step"]): r for r in js.thermo_rows}
    for step, temp, cg in G.SCALAR_GOLDEN[case]:
        r = rows[int(step)]
        assert r["temp"] == pytest.approx(temp, rel=1e-9)
        assert r[f"c_g_{case}"] == pytest.approx(cg, rel=1e-9)
        assert r[f"c_g_{case}"] == pytest.approx(
            jrows[int(step)][f"c_g_{case}"], rel=REL)


# fix ave/chunk over the LJ melt: each chunking with its values, file and
# fix arguments (Nrepeat*Nevery == Nfreq, and below it, where both
# packages accumulate every Nevery sample since the last output)
MELT = """units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 4 0 4 0 5
create_box 2 box
create_atoms 1 box
mass 1 1.0
mass 2 2.0
region left block 0 2 0 4 0 5
set region left type 2
pair_style lj/cut 2.5
pair_coeff * * 1.0 1.0 2.5
velocity all create 1.44 87287 loop geom
fix 1 all nve
region low block INF INF INF INF 0 2.5
group low region low
compute c1 all chunk/atom bin/1d z lower 0.05 units reduced
compute c2 low chunk/atom bin/2d x center 1.5 y lower 2.0 units box
compute c3 all chunk/atom bin/3d x lower 0.5 y 0.3 0.5 z upper 0.25 \
units reduced
compute c4 all chunk/atom type
compute c5 all chunk/atom bin/1d y 1.25 0.75
fix a1 all ave/chunk 2 2 4 c1 vx density/number temp file a1.out
fix a2 all ave/chunk 1 2 4 c2 vy fz density/mass file a2.out
fix a3 all ave/chunk 2 1 4 c3 density/mass fx vz file a3.out
fix a4 all ave/chunk 4 1 4 c4 temp density/number vx fy file a4.out
fix a5 all ave/chunk 2 2 4 c5 vz density/number file a5.out
fix a3l all ave/chunk 4 1 4 c3 density/mass fx vz
thermo 4
run 8
run 4
"""
AVE_FILES = ("a1.out", "a2.out", "a3.out", "a4.out", "a5.out")


@pytest.fixture(scope="module")
def ave_runs(tmp_path_factory):
    return _both(tmp_path_factory, "ave", MELT)


@pytest.mark.parametrize("name", AVE_FILES)
def test_ave_chunk_files_match_jax(ave_runs, name):
    (js, jwork), (ts, twork) = ave_runs["jax"], ave_runs["torch"]
    text = _file_text(twork, name)
    assert text.count("\n") > 5
    assert same_text(text, _file_text(jwork, name)) == 0
    fid = name.split(".")[0]
    (jstep, jrows), (tstep, trows) = (js.ave_chunk_values[fid],
                                      ts.ave_chunk_values[fid])
    assert tstep == jstep == 12
    a, b = np.asarray(trows, float), np.asarray(jrows, float)
    assert a.shape == b.shape
    assert (np.abs(a - b) <= REL * np.maximum(1.0, np.abs(b))).all()


def test_ave_chunk_nrepeat_gap(ave_runs):
    """Both packages average every Nevery sample since the last output:
    a3 (Nevery 2, Nrepeat 1, Nfreq 4) averages steps 10 and 12, where
    LAMMPS's FixAveChunk averages step 12 alone, as a3l (4 1 4) does
    (ROADMAP queue 3 item 41).  The gap is measured here."""
    for pkg in ("jax", "torch"):
        s = ave_runs[pkg][0]
        a = np.asarray(s.ave_chunk_values["a3"][1], float)
        b = np.asarray(s.ave_chunk_values["a3l"][1], float)
        assert np.array_equal(a[:, :4], b[:, :4])   # chunk, coords
        gap = np.abs(a[:, 6:] - b[:, 6:]).max(0) / np.abs(b[:, 6:]).max(0)
        assert (gap > 1e-2).all(), gap
    print(f"ave/chunk 2 1 4 against 4 1 4 (fx, vz): {gap} of each column's "
          "largest")


def test_chunk_ids_match_jax(ave_runs):
    """Every chunking's ids, count and printed coordinates on the final
    state against JAX's _chunk_ids, the ids exactly."""
    js, ts = ave_runs["jax"][0], ave_runs["torch"][0]
    for cid in ("c1", "c2", "c3", "c4", "c5"):
        jids, jn, jcoord = js._sim._chunk_ids(cid)
        ids, nchunk, coord = tcomputes.chunk_ids(ts._sim, cid)
        assert nchunk == jn
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        if jcoord is None:
            assert coord is None
        else:
            np.testing.assert_array_equal(coord, jcoord)
    assert tcomputes.chunk_ids(ts._sim, "c3")[1] > 20


def _analytic(extra, nx=8):
    s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                             log=lambda line: None)
    s.execute(f"""units lj
atom_style atomic
boundary p p p
lattice sc 0.8
region box block 0 {nx} 0 4 0 4
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 1.1
pair_coeff 1 1 0.0 1.0
neighbor 0.3 bin
fix 1 all nve
""".strip().splitlines() + extra)
    return s


def test_velocity_profile_bins():
    """tests/test_ave_chunk.py's linear vx(x) profile per bin, its number
    density uniform."""
    s = _analytic([
        "compute cc all chunk/atom bin/1d x lower 0.125 units reduced",
        "fix 2 all ave/chunk 1 1 2 cc vx density/number"])
    n = len(s.x)
    L = float(s.box_hi[0] - s.box_lo[0])
    s.v = np.zeros((n, 3))
    s.v[:, 0] = s.x[:, 0] / L
    s.one("run 2")
    step, rows = s.ave_chunk_values["2"]
    assert step == 2 and len(rows) == 8
    vol_bin = (L / 8) * L / 2 * L / 2
    for k, row in enumerate(rows):
        cid, coord, ncount, vx, dens = row
        assert cid == k + 1
        assert ncount == 16.0
        assert abs(dens - 16.0 / vol_bin) < 1e-10
        assert abs(vx - k * (L / 8) / L) < 0.05, (k, vx)


def test_chunk_type_and_temp():
    """tests/test_ave_chunk.py's type-chunked temperature: sum m v^2 /
    (3 N kB) of the evolved state."""
    s = _analytic(["compute cc all chunk/atom type",
                   "fix 2 all ave/chunk 1 1 1 cc temp"])
    n = len(s.x)
    s.v = np.random.RandomState(0).normal(size=(n, 3))
    s.one("run 1")
    _, rows = s.ave_chunk_values["2"]
    assert len(rows) == 1
    vv = s._sim.sys.v[:n].numpy()
    assert abs(rows[0][-1] - (vv * vv).sum() / (3.0 * n)) < 1e-10


# molecule chunks on harmonic bead-spring chains (chip_smoke's
# chain_script_case writes the data: 8 chains of 25 beads, a seed)
CHAIN = """units lj
atom_style bond
special_bonds lj 0.0 1.0 1.0
read_data data.chain
bond_style harmonic
bond_coeff 1 100.0 0.97
pair_style lj/cut 1.12
pair_modify shift yes
pair_coeff 1 1 1.0 1.0 1.12
group front molecule <= 5
compute mol all chunk/atom molecule
compute mfront front chunk/atom molecule
compute com all com/chunk mol
compute vcm all vcm/chunk mol
compute gyr all gyration/chunk mol
compute gyt all gyration/chunk mol tensor
compute ang all angmom/chunk mol
compute tor all torque/chunk mol
compute ine all inertia/chunk mol
compute ome all omega/chunk mol
compute dip all dipole/chunk mol geometry
compute msd all msd/chunk mol
compute pro all property/chunk mol count id
compute tch all temp/chunk mol temp kecom internal com yes adof 2 cdof 1
compute tsc front temp/chunk mfront cdof 1.5
compute sl all slice 2 7 2 c_gyr
compute sl3 all slice 1 8 3 c_com[1] c_ome[3]
compute gs all global/atom c_mol c_gyr c_msd[4]
compute rs all reduce sum c_gs[1] c_gs[2]
fix 1 all nve
fix v1 all ave/time 2 2 4 c_com c_vcm c_gyr c_gyt c_ang c_tor mode vector \
file mol1.out
fix v2 all ave/time 2 1 4 c_ine c_ome c_dip c_msd c_pro c_tch mode vector \
file mol2.out
fix v3 all ave/time 4 1 4 c_sl3 c_sl mode vector file mol3.out
fix ac all ave/chunk 2 2 4 mol vx fy density/mass temp file mol4.out
dump d all custom 6 mol.dump id c_mol c_mfront c_gs[1] c_gs[2]
dump_modify d format float %.10g
thermo_style custom step temp pe c_tsc c_rs[1] c_rs[2] c_sl[1] c_sl[3]
thermo 2
run 12
"""
MOL_FILES = ("mol1.out", "mol2.out", "mol3.out", "mol4.out", "mol.dump")


def _chains(work):
    import chip_smoke

    chip_smoke.chain_script_case(work, n_chains=8, n_beads=25)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    return _both(tmp_path_factory, "chains", CHAIN, setup=_chains)


@pytest.mark.parametrize("name", MOL_FILES)
def test_molecule_files_match_jax(chains, name):
    (js, jwork), (ts, twork) = chains["jax"], chains["torch"]
    text = _file_text(twork, name)
    assert text.count("\n") > 10
    same_text(text, _file_text(jwork, name))


def test_molecule_rows_match_jax(chains):
    js, ts = chains["jax"][0], chains["torch"][0]
    assert len(ts.thermo_rows) == len(js.thermo_rows) == 7
    for jr, tr in zip(js.thermo_rows, ts.thermo_rows):
        for k in ts.thermo_columns:
            assert abs(tr[k] - jr[k]) <= REL * max(1.0, abs(jr[k])), \
                (tr["step"], k)
    assert ts.thermo_rows[-1]["c_rs[1]"] > 0
    for fid in ("v1", "v2", "v3"):
        for (ss, a), (sj, b) in zip(ts.ave_time_values[fid],
                                    js.ave_time_values[fid]):
            assert ss == sj
            a, b = np.asarray(a), np.asarray(b)
            assert np.abs(a - b).max() <= REL * max(1.0, np.abs(b).max()), \
                fid
    a = np.asarray(ts.ave_chunk_values["ac"][1])
    b = np.asarray(js.ave_chunk_values["ac"][1])
    assert (np.abs(a - b) <= REL * np.maximum(1.0, np.abs(b))).all()


@pytest.mark.parametrize("cid", ["com", "vcm", "gyr", "gyt", "ang", "tor",
                                 "ine", "ome", "dip", "msd", "pro", "tch"])
def test_molecule_arrays_match_jax(chains, cid):
    """Each */chunk array on the final state against JAX's
    eval_chunk_agg (rel 1e-10 of its largest entry), and repeated bit for
    bit on a fresh cache."""
    from lidp_tpu import computes as jcomputes

    js, ts = chains["jax"][0], chains["torch"][0]
    want = np.asarray(jcomputes.eval_chunk_agg(js._sim, cid), float)
    got = tcomputes.eval_chunk_agg(ts._sim, cid)
    assert got.shape == want.shape == (8, got.shape[1])
    big = max(1e-300, np.abs(want).max())
    assert np.abs(got.numpy() - want).max() <= REL * max(1.0, big), cid
    ts._sim._peratom = (None, None, {})
    assert torch.equal(tcomputes.eval_chunk_agg(ts._sim, cid), got)


def test_cli_runs_chunk_script(tmp_path):
    """`python -m lidp_tpu_torch -in` on the molecule script: its files
    equal those of the run in this process."""
    _chains(str(tmp_path))
    (tmp_path / "in.mol").write_text(CHAIN)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   filter(None, (ROOT, os.environ.get("PYTHONPATH")))))
    p = subprocess.run([sys.executable, "-m", "lidp_tpu_torch", "-in",
                        "in.mol", "-device", "cpu"], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "Loop time" in p.stdout
    s = _script("torch", tmp_path / "again")
    os.makedirs(s.root)
    _chains(s.root)
    s.execute(CHAIN.splitlines())
    for name in MOL_FILES:
        assert _file_text(tmp_path, name) == _file_text(s.root, name)


SKIPPED = {
    "discard": "compute c all chunk/atom bin/1d x lower 0.5 discard yes",
    "nchunk": "compute c all chunk/atom type nchunk once",
    "limit": "compute c all chunk/atom molecule limit 4 max",
    "compress": "compute c all chunk/atom molecule compress yes",
    "bound": "compute c all chunk/atom bin/1d x lower 0.5 bound x 0 1",
    "region": "compute c all chunk/atom bin/1d x lower 0.5 region r",
    "pbc": "compute c all chunk/atom bin/1d x lower 0.5 pbc yes",
    "ids": "compute c all chunk/atom molecule ids every",
    "units other": "compute c all chunk/atom bin/1d x lower 0.5 units x",
    "com extra": "compute c2 all com/chunk cc com",
    "gyration extra": "compute c2 all gyration/chunk cc mass",
    "norm": "fix f all ave/chunk 1 1 1 cc vx norm all",
    "ave": "fix f all ave/chunk 1 1 1 cc vx ave running",
    "bias": "fix f all ave/chunk 1 1 1 cc temp bias tt",
    "c_ID": "fix f all ave/chunk 1 1 1 cc c_ka",
    "adof": "fix f all ave/chunk 1 1 1 cc temp adof 2",
    "format": "fix f all ave/chunk 1 1 1 cc vx format %g",
    "title1": "fix f all ave/chunk 1 1 1 cc vx title1 t",
    "overwrite": "fix f all ave/chunk 1 1 1 cc vx overwrite",
    "structure extra": "compute c2 all fragment/atom single no",
}
REFUSED = {
    "bin/sphere": "compute c all chunk/atom bin/sphere 0 0 0 0 5 4",
    "bin/cylinder": "compute c all chunk/atom bin/cylinder z lower 0.1 "
                    "0 0 0 5 4",
    "other style": "compute c all chunk/atom compute/fix c_x",
    "no chunk compute": "compute c2 all com/chunk tt",
    "temp/chunk value": "compute c2 all temp/chunk cc bias tt",
    "property field": "compute c2 all property/chunk cc mass",
    "vector of a scalar": "fix f all ave/time 1 1 1 c_tt mode vector",
    "ave/chunk Nfreq": "fix f all ave/chunk 2 1 3 cc vx",
}


def _front(line):
    s = _script("torch", ".")
    s.execute(MELT.split("velocity")[0].splitlines()
              + ["compute cc all chunk/atom type", "compute tt all temp",
                 "compute ka all ke/atom"])
    s.one(line)


@pytest.mark.parametrize("name", list(SKIPPED))
def test_skipped_keywords_raise(name):
    with pytest.raises(NotImplementedError, match="queue 3 item 25"):
        _front(SKIPPED[name])


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_arguments_raise(name):
    with pytest.raises(ValueError):
        _front(REFUSED[name])
