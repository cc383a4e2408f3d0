"""The rest of the CHARMM family through the port against the JAX package,
float64 on the CPU:

  * lidp_tpu_torch/ops/pair.py's lj/charmmfsw force switch
    (charmm_fsw_terms) with the long and charmmfsh coulombs, and the
    charmm/implicit coulomb under the energy switch: _pair_terms and
    pair_single against the JAX functions on seeded tables, distances
    across both cutoffs and every special level, rel 1e-12 of the largest
    entry; the tables of make_pair_params against the JAX ones carried by
    convert.pair_from_numpy; the cell pass (ops/cells.py) against JAX's
    dense pass without special codes at rel 1e-12;
  * paths AS, AT and AU of chip_smoke.py at 192 atoms (flexible_script_case
    at n_side (2, 2, 2), cutoffs 4 / 5.5): lj/charmmfsw/coul/long with
    dihedral charmmfsw, pppm, fix shake and fix cmap (energy yes, f_cmap
    in the row); lj/charmmfsw/coul/charmmfsh with dihedral charmmfsw's
    shifted 1-4 coulomb and fix cmap under energy no; and
    lj/charmm/coul/charmm/implicit: both LammpsScripts' rows at rel 1e-8
    of max(1, |value|) and the final x and v within 1e-8 of their largest
    entry; AS also through `python -m lidp_tpu_torch -in`;
  * tests/test_pair_breadth2.py's three LAMMPS goldens of these styles
    (test_charmmfsw_fsh_golden, test_charmmfsw_coul_long_golden and the
    charmm/implicit row of SWITCH_GOLDEN) at that file's bars;
  * where the JAX package's cell route parts from its dense route (ROADMAP
    queue 3 item 38, measured in test_torch_pair_generic.py's
    test_cells_special_correction_per_kind): AS's input above a mocked
    dense cap on the cell grid raises naming the item, and the styles
    without special bonds run there as JAX's dense route does.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin on
# the cores the other workers use
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu import sim as jsim  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu.ops import pair as jpair  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.ops import pair as tpair  # noqa: E402
from lidp_tpu_torch.parallel import fast_polar as tfast  # noqa: E402
from scripts.gen_breadth_goldens import write_data  # noqa: E402
from tests.test_pair_breadth2 import SWITCH_GOLDEN  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
T = 3
SPECIAL_LJ = (1.0, 0.0, 0.3, 0.5)
SPECIAL_COUL = (1.0, 0.1, 0.4, 0.8)
SIDE = (2, 2, 2)
CUT = (4.0, 5.5)
NSTEP = 3
# path -> flexible_script_case's keywords (chip_smoke.py charmm_family)
PATHS = {
    "AS": dict(pair="lj/charmmfsw/coul/long 4 5.5", dihedral="charmmfsw",
               cmap="yes"),
    "AT": dict(pair="lj/charmmfsw/coul/charmmfsh 4 5.5",
               dihedral="charmmfsw", cmap="no", kspace=None),
    "AU": dict(pair="lj/charmm/coul/charmm/implicit 4 5.5", kspace=None),
}
COLS = chip_smoke.FLEX_MULTI
IMPLICIT = "lj/charmm/coul/charmm/implicit 1.8 2.2 1.9 2.4"
# (kind of switch, coulomb kind): the functions' cases
KINDS = [("fsw", "long"), ("fsw", "charmmfsh"), ("fsw", None),
         ("switch", "charmm/implicit")]


def _fields(obj):
    return {f.name: (None if getattr(obj, f.name) is None
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def _close(got, ref, rel, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-300), (what, err)


def _tables(switch, coul):
    """eps, sigma, cut (T+1,T+1) and both packages' PairParams."""
    rs = np.random.RandomState(7)
    e_t, s_t = rs.uniform(0.05, 0.3, T + 1), rs.uniform(2.0, 3.5, T + 1)
    eps = np.sqrt(np.outer(e_t, e_t))
    sig = 0.5 * (s_t[:, None] + s_t[None, :])
    cut = np.full((T + 1, T + 1), 8.0)
    kw = dict(cut_lj_inner=6.0, charmm=True, charmm_fsw=switch == "fsw",
              special_lj=SPECIAL_LJ, special_coul=SPECIAL_COUL, coul=False)
    if coul is not None:
        kw.update(coul=True, cut_coul=9.0, coul_kind=coul, qqrd2e=332.0716,
                  g_ewald=0.3 if coul == "long" else 0.0,
                  cut_coul_inner=7.0)
    pj = jpair.make_pair_params(eps, sig, cut, **kw)
    pt = tpair.make_pair_params(eps, sig, cut, **kw)
    return pj, pt


@pytest.mark.parametrize("switch,coul", KINDS)
def test_tables_match_jax(switch, coul):
    pj, pt = _tables(switch, coul)
    ref = convert.pair_from_numpy(_fields(pj), device="cpu",
                                  dtype=torch.float64)
    for f in dataclasses.fields(ref):
        a, b = getattr(pt, f.name), getattr(ref, f.name)
        if isinstance(b, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=1e-15, atol=0, msg=f.name)
        else:
            assert a == b or abs(a - b) <= 1e-15 * abs(b), f.name
    assert ref.charmm_fsw == (switch == "fsw")


def _pairs_case(n=4000, seed=3):
    """Seeded distances over both cutoffs (the inner and outer LJ ones, the
    coulomb ones), type pairs, charges and special levels."""
    rs = np.random.RandomState(seed)
    return (rs.uniform(1.2 ** 2, 9.5 ** 2, n), rs.randint(1, T + 1, n),
            rs.randint(1, T + 1, n), rs.uniform(-0.9, 0.9, n),
            rs.uniform(-0.9, 0.9, n), rs.randint(0, 4, n))


@pytest.mark.parametrize("switch,coul", KINDS)
def test_pair_terms_match_jax(switch, coul):
    """_pair_terms: (fpair, evdwl, ecoul) at each pair's special level."""
    pj, pt = _tables(switch, coul)
    rsq, ti, tj, qi, qj, sp = _pairs_case()
    mask = np.ones(len(rsq), bool)
    ref = jpair._pair_terms(jnp.asarray(rsq), jnp.asarray(qi),
                            jnp.asarray(qj), jnp.asarray(ti),
                            jnp.asarray(tj), jnp.asarray(sp), pj,
                            jnp.asarray(mask))
    t = torch.as_tensor
    got = tpair._pair_terms(t(rsq), t(qi), t(qj), t(ti).long(),
                            t(tj).long(), t(sp).long(), pt, t(mask))
    for g, r, what in zip(got, ref, ("fpair", "evdwl", "ecoul")):
        if coul is None and what == "ecoul":
            assert not np.asarray(r).any() and not g.any()
            continue
        _close(g.numpy(), r, 1e-12, f"{switch}/{coul} {what}")


@pytest.mark.parametrize("switch,coul", KINDS)
def test_pair_single_matches_jax(switch, coul):
    """pair_single (pair_write, compute pe/atom and group/group) with the
    special factors of each level."""
    pj, pt = _tables(switch, coul)
    rsq, ti, tj, qi, qj, sp = _pairs_case(n=600, seed=5)
    for lvl in range(4):
        fl, fc = SPECIAL_LJ[lvl], SPECIAL_COUL[lvl]
        ref = jpair.pair_single(jnp.asarray(rsq), jnp.asarray(ti),
                                jnp.asarray(tj), jnp.asarray(qi),
                                jnp.asarray(qj), pj, factor_coul=fc,
                                factor_lj=fl)
        got = tpair.pair_single(torch.as_tensor(rsq), ti, tj,
                                torch.as_tensor(qi), torch.as_tensor(qj),
                                pt, factor_coul=fc, factor_lj=fl)
        for g, r, what in zip(got, ref, ("eng", "fforce")):
            _close(g.numpy(), r, 1e-12, f"{switch}/{coul} level {lvl} {what}")


@pytest.mark.parametrize("switch,coul", KINDS)
def test_cell_pass_matches_jax_dense(switch, coul):
    """ops/cells.py's pass at factor 1 against JAX's dense pass without
    special codes, on 300 atoms of three types in a 30 A box (3^3 cells
    of 10 A), the forces, E_vdwl, E_coul and the virial."""
    from lidp_tpu import box as jbox
    from lidp_tpu_torch import box as tbox
    from lidp_tpu_torch.ops import cells as tcells

    pj, pt = _tables(switch, coul)
    rs = np.random.RandomState(9)
    n, L = 300, 30.0
    x = rs.uniform(0.0, L, (n, 3))
    q = rs.uniform(-0.5, 0.5, n)
    typ = rs.randint(1, T + 1, n).astype(np.int32)
    mask = np.ones(n, bool)
    bj = jbox.Box.create(np.zeros(3), np.full(3, L))
    ref = jpair.dense_pair_forces(jnp.asarray(x), jnp.asarray(q),
                                  jnp.asarray(typ), 0, jnp.asarray(mask), bj,
                                  pj)
    bt = tbox.Box.create(np.zeros(3), np.full(3, L), dtype=torch.float64)
    cfg = tcells.CellConfig(nbins=(3, 3, 3), cap=40, cutneigh=10.0)
    xt = torch.as_tensor(x)
    cells = tcells.build_cells(xt, torch.as_tensor(mask), bt, cfg)
    assert not bool(cells.overflow)
    got = tcells.cell_pair_forces(xt, torch.as_tensor(q),
                                  torch.as_tensor(typ), torch.as_tensor(mask),
                                  cells, bt, pt)
    for g, r, what in zip(got, ref, ("f", "evdwl", "ecoul", "virial")):
        if coul is None and what == "ecoul":
            continue
        _close(g.numpy(), r, 1e-12, f"{switch}/{coul} {what}")


# ------------------------------ the scripts -------------------------------

def _write(d, path, **extra):
    chip_smoke.flexible_script_case(str(d), n_side=SIDE, cut=CUT,
                                    **{**PATHS[path], **extra})
    return (d / "in.flex").read_text()


def _run(pkg, d, text, name, cap=None, nstep=NSTEP):
    """`text` through pkg's LammpsScript in directory d (float64; the port
    on the CPU), the dense cap mocked to `cap` where given."""
    path = d / f"in.{name}.{pkg}"
    path.write_text(text)
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    s.variables["nstep"] = str(nstep)
    cap = cap or jsim.DENSE_PATH_MAX_ATOMS
    with mock.patch.object(jsim, "DENSE_PATH_MAX_ATOMS", cap), \
            mock.patch.object(tfast, "DENSE_PATH_MAX_ATOMS", cap):
        s.file(str(path))
    return s


def _agree(ts, js, cols):
    assert len(ts.thermo_rows) == len(js.thermo_rows) == NSTEP + 1
    chip_smoke.rows_agree("jax", ts.thermo_rows, js.thermo_rows,
                          [1e-8] * (NSTEP + 1), cols=cols)
    n = ts._sim.natoms
    for k in ("x", "v"):
        a = getattr(ts._sim.sys, k)[:n].numpy()
        b = np.asarray(getattr(js._sim.sys, k))[:n]
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-8 * np.abs(b).max(), err_msg=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each path's input at 192 atoms through both LammpsScripts, one
    directory each (the data file with its CMAP section, the map file)."""
    out = {}
    for path in PATHS:
        d = tmp_path_factory.mktemp(path)
        text = _write(d, path)
        out[path] = (d, _run("torch", d, text, path),
                     _run("jax", d, text, path))
    return out


@pytest.mark.parametrize("path", list(PATHS))
def test_paths_match_jax(runs, path):
    _, ts, js = runs[path]
    cols = COLS + (("f_cmap",) if "cmap" in PATHS[path] else ())
    _agree(ts, js, cols)
    ff = ts._sim.runner.ff
    assert ts._sim.runner.neighbor_cfg is None
    r0 = ts.thermo_rows[0]
    assert r0["edihed"] != 0.0 and r0["evdwl"] != 0.0
    if path == "AU":
        assert ff.pair.coul_kind == "charmm/implicit" and ff.cmap is None
        return
    assert ff.pair.charmm_fsw and ff.dihedral[0].style == "charmmfsw"
    assert ff.dihedral[0].dihedflag == (path == "AS")
    assert ff.pair.qqrd2e == ff.qqrd2e == 332.0716
    # energy yes folds the crossterms into pe; energy no leaves them out
    for r in ts.thermo_rows:
        parts = (r["evdwl"] + r["ecoul"] + r["elong"] + r["ebond"]
                 + r["eangle"] + r["edihed"] + r["eimp"])
        fold = r["f_cmap"] if PATHS[path]["cmap"] == "yes" else 0.0
        assert abs(r["pe"] - parts - fold) <= 1e-9 * abs(r["pe"])
        assert r["f_cmap"] != 0.0


def test_cli_runs_path_as(runs, tmp_path):
    """AS through `python -m lidp_tpu_torch -in ... -device cpu`: its log's
    rows equal the in-process run's at the printed precision."""
    d, ts, _ = runs["AS"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        filter(None, (str(ROOT), os.environ.get("PYTHONPATH")))))
    log = tmp_path / "log.as"
    res = subprocess.run(
        [sys.executable, "-m", "lidp_tpu_torch", "-in", "in.flex", "-var",
         "nstep", str(NSTEP), "-log", str(log), "-device", "cpu"], cwd=d,
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    rows = chip_smoke.log_rows(log.read_text().splitlines())
    assert len(rows) == NSTEP + 1 and "f_cmap" in rows[0]
    chip_smoke.rows_agree("cli", rows, ts.thermo_rows, [1e-6] * len(rows),
                          cols=COLS + ("f_cmap",))


@pytest.mark.parametrize("path", ["AS", "AU"])
def test_cell_grid_with_special_bonds_raises(tmp_path, path):
    """The input replicated 1 x 1 x 3 (576 atoms) above a dense cap mocked
    to 300: the cell grid with special bonds, where the JAX package's
    correction parts from its dense route (ROADMAP queue 3 item 38)."""
    text = _write(tmp_path, path, cmap=None).replace(
        "read_data flex.data\n", "read_data flex.data\nreplicate 1 1 3\n")
    with pytest.raises(NotImplementedError, match="queue 3 item 38"):
        _run("torch", tmp_path, text, path, cap=300, nstep=1)


IONS = """units real
atom_style full
read_data ions.data
pair_style {pair}
pair_coeff 1 1 0.13 2.6
pair_coeff 2 2 0.1 4.0
velocity all create 300.0 4928459 loop geom
fix 1 all nve
thermo_style custom step temp pe evdwl ecoul press
thermo 1
run ${{nstep}}
"""


@pytest.mark.parametrize("pair", ["lj/charmmfsw/coul/charmmfsh 4 5.5",
                                  IMPLICIT.replace("1.8 2.2 1.9 2.4",
                                                   "4 5.5")])
def test_cell_grid_without_special_bonds_matches_jax(tmp_path, pair):
    """The styles on the cell grid where no pair takes a special factor:
    512 ions (chip_smoke.nacl_layout at 4 cells a side, no bonds) above a
    dense cap mocked to 300, the rows equal the JAX package's at rel
    1e-8."""
    from lidp_tpu_torch.io.data_writer import write_data as twrite

    twrite(str(tmp_path / "ions.data"), chip_smoke.nacl_layout(4))
    text = IONS.format(pair=pair)
    ts = _run("torch", tmp_path, text, "cells", cap=300)
    js = _run("jax", tmp_path, text, "cells", cap=300)
    assert ts._sim.runner.neighbor_cfg is not None
    _agree(ts, js, ("temp", "pe", "evdwl", "ecoul", "press"))


# ------------------------------- goldens ---------------------------------

GOLDEN_RUN = """velocity all create 1.0 87287 loop geom
timestep 0.005
fix 1 all nve
thermo 5
run 5
"""
HEAD = """units lj
atom_style charge
read_data {data}
"""
# tests/test_pair_breadth2.py's rows: step -> (temp, pe, evdwl, ecoul[,
# elong], press)
FSH = {0: (1.0, -1.14747471387, -0.904567057545, -0.242907656322,
           -0.366306512177),
       5: (1.00580226085, -1.15619587224, -0.913223875741,
           -0.242971996502, -0.368041811185)}
LONG = {0: (1.0, -1.48711586758, -0.904567057545, -0.00246372882613,
            -0.580085081204, -0.364550075037),
        5: (1.00593867861, -1.49603843883, -0.913225786853,
            -0.00256795946468, -0.58024469251, -0.366236953668)}


@pytest.fixture(scope="module")
def breadth(tmp_path_factory):
    d = tmp_path_factory.mktemp("breadth")
    write_data(str(d / "data.breadth"))
    return d


def _golden(d, pair, extra=""):
    text = (HEAD.format(data=d / "data.breadth") + f"pair_style {pair}\n"
            "pair_coeff 1 1 1.0 1.0\npair_coeff 2 2 0.8 1.1\n" + extra
            + GOLDEN_RUN)
    s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                             log=lambda line: None)
    (d / "in.golden").write_text(text)
    s.file(str(d / "in.golden"))
    return {int(r["step"]): r for r in s.thermo_rows}


def test_charmmfsw_fsh_golden(breadth):
    got = _golden(breadth, "lj/charmmfsw/coul/charmmfsh 1.8 2.2 2.4")
    for step, (temp, pe, ev, ec, pr) in FSH.items():
        r = got[step]
        assert r["temp"] == pytest.approx(temp, rel=2e-6), step
        assert r["evdwl"] == pytest.approx(ev, rel=2e-6), step
        assert r["ecoul"] == pytest.approx(ec, rel=2e-6), step
        assert r["pe"] == pytest.approx(pe, rel=2e-6), step
        assert r["press"] == pytest.approx(pr, rel=2e-5), step


def test_charmmfsw_coul_long_golden(breadth):
    got = _golden(breadth, "lj/charmmfsw/coul/long 1.8 2.2 2.4",
                  "kspace_style ewald 1.0e-6\n")
    for step, (temp, pe, ev, ec, el, pr) in LONG.items():
        r = got[step]
        assert r["temp"] == pytest.approx(temp, rel=2e-6), step
        assert r["evdwl"] == pytest.approx(ev, rel=2e-6), step
        assert r["ecoul"] == pytest.approx(ec, rel=2e-4, abs=1e-7), step
        assert r["elong"] == pytest.approx(el, rel=2e-5), step
        assert r["pe"] == pytest.approx(pe, rel=2e-6), step
        assert r["press"] == pytest.approx(pr, rel=2e-4), step


def test_charmm_implicit_golden(breadth):
    got = _golden(breadth, IMPLICIT)
    for step, (temp, pe, ev, ec, pr) in SWITCH_GOLDEN[IMPLICIT].items():
        r = got[step]
        assert r["temp"] == pytest.approx(temp, rel=2e-6), step
        assert r["evdwl"] == pytest.approx(ev, rel=2e-6), step
        assert r["ecoul"] == pytest.approx(ec, rel=2e-6), step
        assert r["pe"] == pytest.approx(pe, rel=2e-6), step
