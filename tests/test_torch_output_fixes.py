"""The port's output fixes and compute front end (styles/fix_output.py,
io/script.py cmd_compute, uncompute, compute_modify, io/dump.py's c_/f_
columns, api.py) against the JAX package, float64 on the CPU:

  * one LJ melt (tests/test_analysis_fixes.py's base, 108 atoms) with com,
    gyration, ke, pe, temp/partial, temp/com, temp with compute_modify
    extra, msd, ke/atom and pe/atom with reduce, pressure (temp-ID and
    NULL), an uncomputed compute, fix print, two fix
    ave/time (one with its setup-step sample), ave/atom read by dump
    custom's f_ID columns, ave/histo, ave/correlate and vector, over two
    `run`s: the thermo rows within rel 1e-10 of max(1, |value|) of
    JAX's; the print lines, the fixes' files and the dump text equal to
    JAX's character for character, and their kept values (ave_time_values,
    ave_histo_values, ave_correlate_values, fix vector's series) within
    rel 1e-10;
  * test_analysis_fixes.py's msd and rdf through the port's api.lammps:
    msd's vector and rdf's (Nbin, 3) array (its counts exactly) against
    JAX's api.lammps;
  * what the port does not take raises NotImplementedError naming its
    ROADMAP item: the compute styles and fixes of later slices, the
    keywords JAX's output fixes skip unread, the values JAX's thermo row
    lacks (f_ID), the other dump columns, the library calls on a fix that
    is not fix external.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from lidp_tpu import api as japi  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch import api as tapi  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402

BASE = """units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 3 0 3 0 3
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
velocity all create 1.0 12345 loop geom
"""
TEXT = BASE + """region half block 0 1.5 0 3 0 3
group half region half
compute c1 all com
compute rg all gyration
compute ek all ke
compute ep all pe
compute tx all temp/partial 1 0 0
compute tc all temp/com
compute tt all temp
compute th half temp
compute_modify th extra 1
compute m all msd
compute ka all ke/atom
compute pa all pe/atom
compute rk all reduce max c_ka
compute rs all reduce sum c_pa c_ka
compute pr all pressure tt
compute pv all pressure NULL
compute dead all ke
uncompute dead
variable twice equal 2*c_tt
fix 1 all nve
fix aa all ave/atom 2 3 6 c_ka c_pa
fix 2 all print 10 "T=${temp} step=${step} pe=${pe}"
fix 3 all ave/time 2 5 10 c_tt c_ek c_m[4] file ave.out
fix 7 all ave/time 4 1 4 c_rg c_tx file ave1.out
fix 4 all ave/histo 2 3 6 -7.5 -4.5 10 c_pa file histo.out
fix 5 all ave/correlate 2 4 8 c_tt c_ep file corr.out
fix 6 all vector 4 c_tt c_ek
thermo_style custom step temp pe c_c1[1] c_c1[2] c_c1[3] c_rg c_ek c_ep \
c_tx c_tc c_th c_m[4] c_rk c_rs[1] c_rs[2] c_pr c_pv v_twice
thermo 6
dump d1 all custom 12 dump.out id type x c_ka c_pa f_aa[1] f_aa[2]
run 24
run 12
"""
FILES = ("ave.out", "ave1.out", "histo.out", "corr.out", "dump.out")
REL = 1e-10


def _script(pkg, log=None, root=None):
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64,
                                 log=log or (lambda line: None))
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                                 log=log or (lambda line: None))
    if root is not None:
        s.root = root
    return s


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """TEXT through both packages, each in a directory of its own: (script,
    log lines, directory) by package."""
    out = {}
    for pkg in ("jax", "torch"):
        work = tmp_path_factory.mktemp(pkg)
        logs = []
        s = _script(pkg, logs.append, str(work))
        s.execute(TEXT.splitlines())
        out[pkg] = (s, logs, work)
    return out


def _close(a, b):
    return abs(a - b) <= REL * max(1.0, abs(b))


def test_rows_match_jax(runs):
    js, ts = runs["jax"][0], runs["torch"][0]
    assert [r["step"] for r in ts.thermo_rows] == [0, 6, 12, 18, 24, 24, 30,
                                                   36]
    assert len(js.thermo_rows) == len(ts.thermo_rows)
    for jr, tr in zip(js.thermo_rows, ts.thermo_rows):
        for k in ts.thermo_columns:
            assert _close(tr[k], jr[k]), (tr["step"], k, tr[k], jr[k])
    # lj units: thermo normalizes reduce sum and pe, not compute ke / pe
    r = ts.thermo_rows[-1]
    n = ts._sim.natoms
    assert abs(r["c_ep"] - r["pe"] * n) <= 1e-10 * abs(r["c_ep"])
    assert abs(r["c_rs[1]"] - r["pe"]) <= 1e-10 * abs(r["pe"])
    assert "c_dead" not in r


def test_print_lines_match_jax(runs):
    jp = [w for w in runs["jax"][1] if w.startswith("T=")]
    tp = [w for w in runs["torch"][1] if w.startswith("T=")]
    assert tp == jp
    assert [w.split()[1] for w in tp] == ["step=10", "step=20", "step=30"]


@pytest.mark.parametrize("name", FILES)
def test_files_match_jax(runs, name):
    want = (runs["jax"][2] / name).read_text()
    got = (runs["torch"][2] / name).read_text()
    assert got == want
    assert len(got.splitlines()) > 2


def test_kept_values_match_jax(runs):
    js, ts = runs["jax"][0], runs["torch"][0]
    for fid in ("3", "7"):
        jv, tv = js.ave_time_values[fid], ts.ave_time_values[fid]
        assert [s for s, _ in tv] == [s for s, _ in jv]
        for (_, a), (_, b) in zip(tv, jv):
            a, b = np.atleast_1d(a), np.atleast_1d(b)
            assert np.abs(a - b).max() <= REL * np.abs(b).max()
    jh, th = js.ave_histo_values["4"], ts.ave_histo_values["4"]
    assert np.array_equal(th["hist"], jh["hist"])
    assert (th["total"], th["missing"]) == (jh["total"], jh["missing"])
    jc, jn = js.ave_correlate_values["5"]
    tc, tn = ts.ave_correlate_values["5"]
    assert np.array_equal(tn, jn)
    assert np.abs(tc - jc).max() <= REL * np.abs(jc).max()
    jser = np.asarray(js.fixes["6"]._series)
    tser = np.asarray(ts.fixes["6"]._series)
    assert tser.shape == jser.shape == (10, 2)
    assert np.abs(tser - jser).max() <= REL * np.abs(jser).max()


def test_ave_atom_store_matches_jax(runs):
    js, ts = runs["jax"][0], runs["torch"][0]
    want = np.asarray(js.fixes["aa"]._peratom_store)
    got = ts.fixes["aa"]._peratom_store.numpy()
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.fixture(scope="module")
def api_runs():
    """test_analysis_fixes.py's msd and rdf cases through both packages'
    api.lammps: (msd at step 0, msd at step 50, rdf at step 20) each."""
    out = {}
    for pkg, mod in (("jax", japi), ("torch", tapi)):
        kw = {} if pkg == "jax" else dict(device="cpu")
        L = mod.lammps(**kw)
        L.commands_string(BASE + "compute m all msd\nfix 1 all nve\n")
        m0 = L.extract_compute("m")
        L.command("run 50")
        m1 = L.extract_compute("m")
        L.close()
        L = mod.lammps(**kw)
        L.commands_string(BASE + "compute r all rdf 50\nfix 1 all nve\n"
                          "run 20\n")
        rdf = L.extract_compute("r")
        L.close()
        out[pkg] = (m0, m1, rdf)
    return out


def test_api_msd_matches_jax(api_runs):
    (j0, j1, _), (t0, t1, _) = api_runs["jax"], api_runs["torch"]
    assert t0.shape == (4,) and np.allclose(t0, 0.0)
    assert t1[3] > 1e-3
    assert np.abs(t1 - j1).max() <= REL * np.abs(j1).max()


def test_api_rdf_matches_jax(api_runs):
    jr, tr = api_runs["jax"][2], api_runs["torch"][2]
    assert tr.shape == (50, 3)
    assert np.array_equal(tr[:, 0], jr[:, 0])
    # the counts exactly: coord is their running sum times 2 / N
    assert np.array_equal(np.round(tr[:, 2] * 108 / 2),
                          np.round(jr[:, 2] * 108 / 2))
    assert np.abs(tr - jr).max() <= REL * np.abs(jr).max()
    r, g = tr[:, 0], tr[:, 1]
    assert g[r < 0.85].max() == 0.0
    assert g[(r > 1.0) & (r < 1.25)].max() > 1.5


def test_api_surface(tmp_path):
    L = tapi.lammps(cmdargs=["-log", str(tmp_path / "log"), "-var", "t",
                             "1.0"], device="cpu")
    L.commands_string(BASE.replace("create 1.0", "create ${t}")
                      + "fix 1 all nve\n")
    assert L.get_natoms() == 108
    assert L.extract_global("ntypes") == 1
    assert abs(L.get_thermo("temp") - 1.0) < 1e-12
    x = L.extract_atom("x")
    assert x.shape == (108, 3)
    L.scatter_atoms("x", x + 0.01)
    assert np.allclose(L.extract_atom("x"), x + 0.01)
    assert L.extract_atom("f").shape == (108, 3)
    # fix external is ported (tests/test_torch_external.py): fix 1 is not
    # one
    with pytest.raises(ValueError, match="not a fix external"):
        L.set_fix_external_callback("1", lambda *a: None)
    with pytest.raises(ValueError, match="not a fix external"):
        L.fix_external_set_force("1", np.zeros((108, 3)))
    P = tapi.PyLammps(device="cpu")
    for line in BASE.splitlines():
        cmd, *args = line.split()
        getattr(P, cmd)(*args)
    P.compute("ek all ke")
    P.run(0)
    assert P.atoms == 108
    assert abs(P.lmp.extract_compute("ek") - 0.5 * 107 * 3 * 1.0) < 1e-9
    L.close()


UNPORTED = {
    "compute td all temp/deform": "item 6.1",
    "compute m2 all msd com yes": "queue 3 item 25",
    "compute r2 all rdf 50 1 1": "queue 3 item 25",
    "compute p2 all pressure tt ke": "queue 3 item 25",
    "compute_modify tt extra/dof 2": "queue 3 item 25",
    "fix a all ave/time 1 1 1 c_tt ave running": "queue 3 item 25",
    "fix a all ave/time 1 1 1 c_tt start 10": "queue 3 item 25",
    "fix a all ave/time 1 1 1 c_tt format %g": "queue 3 item 25",
    "fix a all ave/time 1 1 1 c_tt off 1": "queue 3 item 25",
    "fix a all ave/time 1 1 1 c_tt title1 t": "queue 3 item 25",
    "fix a all ave/time 1 1 1 c_tt title2 t": "queue 3 item 25",
    "fix a all ave/time 1 1 1 c_tt title3 t": "queue 3 item 25",
    "fix a all ave/time 1 1 1 f_x": "queue 3 item 26",
    "fix a all ave/histo 1 1 1 0 1 10 vx mode vector": "queue 3 item 25",
    "fix a all ave/correlate 1 2 2 c_tt type cross": "queue 3 item 25",
    'fix p all print 1 "x" screen no': "queue 3 item 25",
    "thermo_style custom step f_x": "queue 3 item 26",
    "dump d all custom 1 d.out id v_x": "item 6",
}


# the chunk computes, the structure computes, heat/flux, fix ave/chunk and
# ave/time mode vector are ported (tests/test_torch_chunk_computes.py,
# tests/test_torch_structure_computes.py): these cases keep their names
# and hold a line that still raises
REPOINTED = {
    "compute ch all chunk/atom molecule": (
        "compute ch all chunk/atom molecule nchunk once", "queue 3 item 25"),
    "compute cc all com/chunk cid": (
        "compute cc all property/local patom1 cutoff type",
        "queue 3 item 25"),
    "compute cn all centro/atom fcc": ("compute cn all contact/atom 2.0",
                                       "queue 3 item 25"),
    # the sphere computes are ported (tests/test_torch_gran_script.py): a
    # keyword the JAX package does not read still raises
    "compute es all erotate/sphere": ("compute es all temp/sphere bias tt",
                                      "queue 3 item 25"),
    "compute hf all heat/flux ka pa sa": (
        "compute hf all angle/local theta set theta t", "queue 3 item 25"),
    "fix ac all ave/chunk 1 1 1 cid vx": (
        "fix ac all ave/chunk 1 1 1 cid vx norm sample", "queue 3 item 25"),
    "fix a all ave/time 1 1 1 c_tt mode vector": (
        "fix a all ave/time 1 1 1 c_tt mode vector ave running",
        "queue 3 item 25"),
    # the local computes, dump local, store/state, controller, external
    # and the other dump styles are ported
    # (tests/test_torch_output_styles.py, tests/test_torch_external.py):
    # a keyword or value the JAX package does not take still raises
    "compute pl all pair/local dist": (
        "compute pl all pair/local dist cutoff type", "queue 3 item 25"),
    "fix s all store/state 0 x": ("fix s all store/state 0 x com yes",
                                  "queue 3 item 25"),
    "fix c all controller 1 1 1 1 1 temp 1.0 v": (
        "fix c all controller 1 1 1 1 1 f_x 1.0 v", "queue 3 item 26"),
    "fix e all external pf/callback 1 1": ("fix e all store/force",
                                           "item 6.1"),
    "dump d all xyz 1 d.xyz": (
        "dump d all image 1 d.ppm type type shiny 0.5", "queue 3 item 25"),
    "dump d all local 1 d.loc index": ("dump d all local 1 d.loc index v_x",
                                       "queue 1 item 4"),
}


@pytest.mark.parametrize("line", list(UNPORTED) + list(REPOINTED))
def test_unported_raise(line):
    line, item = REPOINTED.get(line, (line, UNPORTED.get(line)))
    s = _script("torch")
    s.execute((BASE + "compute tt all temp\n").splitlines())
    with pytest.raises(NotImplementedError, match=item):
        s.one(line)


def test_missing_row_value_raises():
    """A value JAX samples as 0.0 (a v_NAME outside the thermo columns)
    raises at its sample step, naming queue 3 item 26."""
    s = _script("torch")
    s.execute((BASE + "variable a equal 1.0\nfix 1 all nve\n"
               "fix v all vector 1 v_a\n").splitlines())
    with pytest.raises(NotImplementedError, match="queue 3 item 26"):
        s.one("run 1")
