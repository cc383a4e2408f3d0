"""The DREIDING hydrogen bonds (lidp_tpu_torch/ops/hbond.py; the grammar
of pair_style hbond/dreiding/lj and /morse in io/script.py, alone and as a
hybrid sub-style, and their setup in sim.py and styles/pair_builders.py)
against the JAX package (lidp_tpu/ops/hbond.py), float64 on the CPU:

  * make_hbond_params: the (donor, hydrogen) rows, the (i, j, k) parameter
    table with `*` ranges and either donor flag, the per-row settings and
    the special factors, equal to JAX's;
  * hbond_forces with the lj and the morse rows on a seeded box of 24
    waters and three acceptors placed by hand: one just inside the angle
    gate and one just outside it, one just past the outer cutoff; f,
    E_vdwl and the virial at rel 1e-12 of the largest entry; the same in
    blocks of a few rows (HBOND_BLOCK_PAIRS made small), and its repeats
    bit for bit;
  * path AV of chip_smoke.py at 81 waters (hybrid/overlay lj/cut/coul/long
    10.0 with hbond/dreiding/lj, pppm, fix nvt) and the morse form alone
    (no k-space): both LammpsScripts' rows at rel 1e-8 of max(1,
    |value|), the final x and v within 1e-8 of their largest entry;
  * tests/test_hbond.py's two LAMMPS goldens at that file's bars;
  * what the JAX package refuses (a system without bonds: ValueError) and
    what the port refuses (neigh_modify exclude, ROADMAP queue 3 item 40).
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin on
# the cores the other workers use
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu import box as jbox  # noqa: E402
from lidp_tpu import topology as jtopo  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu.ops import hbond as jhb  # noqa: E402
from lidp_tpu_torch import box as tbox  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.io.data_writer import write_data  # noqa: E402
from lidp_tpu_torch.ops import hbond as thb  # noqa: E402
from tests.test_hbond import GOLDEN, HB_LINE  # noqa: E402
from tests.test_hbond import write_data as write_golden_data  # noqa: E402

L = 14.0
NW = 24
SPECIAL_LJ = (1.0, 0.0, 0.0, 0.5)
NSTEP = 3
# raw pair_coeff rows [i, j, k, flag, coefficients...]: type 1 water O,
# 2 water H, 3 an acceptor of its own
ROWS = {
    "lj": [["1", "1*3", "2", "i", "3.5", "2.75"],
           ["3", "1", "2", "j", "1.5", "3.0", "2", "5.0", "7.0", "80"]],
    "morse": [["1", "1*3", "2", "i", "3.88", "1.7241379", "2.9"],
              ["3", "1", "2", "j", "1.2", "1.5", "3.1", "4", "5.0", "7.0",
               "100"]],
}
SETTINGS = {"lj": (4, 6.0, 8.0, 90.0), "morse": (2, 6.0, 8.0, 90.0)}


def _box(nw=NW, box=L):
    """nw waters at random in a box^3 box and three type-3 acceptors
    placed against the first water (O at row 0, H at row 1): one at 95
    degrees from the D-H axis at 3 A (inside the 90 degree gate), one at
    90 - 1e-6 degrees (outside), one at the outer cutoff plus 1e-6 from
    the donor along the D-H axis."""
    rs = np.random.RandomState(17)
    th = np.deg2rad(104.52)
    x, bonds = [], []
    for m in range(nw):
        o = rs.uniform(0.0, box, 3)
        q = rs.normal(size=3)
        e1 = q / np.linalg.norm(q)
        e2 = np.cross(e1, rs.normal(size=3))
        e2 /= np.linalg.norm(e2)
        x += [o, o + 0.9572 * e1,
              o + 0.9572 * (np.cos(th) * e1 + np.sin(th) * e2)]
        bonds += [(3 * m + 1, 3 * m + 2), (3 * m + 1, 3 * m + 3)]
    d, h = x[0], x[1]
    u = (h - d) / np.linalg.norm(h - d)
    w = np.cross(u, [0.0, 0.0, 1.0])
    w /= np.linalg.norm(w)
    for deg, r in ((95.0, 3.0), (90.0 - 1e-6 * 180.0 / np.pi, 3.0)):
        a = np.deg2rad(180.0 - deg)      # the D-H...A angle at H
        x.append(h + r * (np.cos(a) * u + np.sin(a) * w))
    x.append(d + (8.0 + 1e-6) * u)
    x = np.array(x) % box
    typ = np.array([1, 2, 2] * nw + [3, 3, 3], np.int32)
    return x, typ, np.array(bonds)


def _params(form, x, typ, bonds):
    n = x.shape[0]
    code = jtopo.special_codes_dense(n, bonds)
    ap, ci, co, ang = SETTINGS[form]
    args = (ROWS[form], 3, ap, ci, co, ang, bonds, n)
    pj = jhb.make_hbond_params(*args, n, typ, list(SPECIAL_LJ),
                               special_code=code, morse=form == "morse")
    pt = thb.make_hbond_params(*args, typ, list(SPECIAL_LJ),
                               special_code=code, morse=form == "morse")
    return form, x, typ, pj, pt


@pytest.fixture(scope="module", params=list(ROWS))
def params(request):
    return _params(request.param, *_box())


def test_params_match_jax(params):
    form, _, _, pj, pt = params
    for f in dataclasses.fields(pj):
        a, b = getattr(pt, f.name), getattr(pj, f.name)
        if f.name == "morse":
            assert a == b
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f.name)
    # the rows of each donor and hydrogen, in row order
    m = int(pt.dh_valid.sum())
    for a, rows in enumerate(pt.d_rows.numpy()):
        assert list(rows[rows < m]) == list(
            np.flatnonzero(pt.dh[:m, 0].numpy() == a))


def _forces(params, block=None, box=L):
    form, x, typ, pj, pt = params
    n = x.shape[0]
    bt = tbox.Box.create(np.zeros(3), np.full(3, box), dtype=torch.float64)
    with mock.patch.object(thb, "HBOND_BLOCK_PAIRS",
                           block or thb.HBOND_BLOCK_PAIRS):
        return thb.hbond_forces(torch.as_tensor(x),
                                torch.ones(n, dtype=torch.bool), bt, pt)


def test_forces_match_jax(params):
    form, x, typ, pj, pt = params
    n = x.shape[0]
    bj = jbox.Box.create(np.zeros(3), np.full(3, L))
    ref = jhb.hbond_forces(jnp.asarray(x), jnp.ones(n, bool), bj, pj)
    got = _forces(params)
    for g, r, what in zip(got, ref, ("f", "evdwl", "virial")):
        r = np.asarray(r)
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 1e-12 * float(np.abs(r).max()), (form, what, err)


@pytest.mark.parametrize("form", list(ROWS))
def test_gate_and_cutoff(form):
    """The first water alone with the hand-placed acceptors in a 30 A box:
    the one inside the angle gate takes a force, the one outside it and
    the one past the outer cutoff none (test_forces_match_jax holds the
    same atoms to the JAX package among the other waters)."""
    x, typ, bonds = _box(1, 30.0)
    got = _forces(_params(form, x + 10.0, typ, bonds), box=30.0)
    f = got[0].numpy()
    assert np.abs(f[-3]).max() > 0.0
    assert not np.abs(f[-2:]).any()
    assert float(got[1]) != 0.0


def test_blocks_match_one_pass(params):
    """Blocks of 2-3 rows (HBOND_BLOCK_PAIRS 200 against 75 atoms) give
    the one-pass result at rel 1e-13, and repeat bit for bit."""
    one = _forces(params)
    blocked = _forces(params, block=200)
    again = _forces(params, block=200)
    for a, b, c in zip(one, blocked, again):
        assert torch.equal(b, c)
        assert float((a - b).abs().max()) <= 1e-13 * float(a.abs().max())


# ------------------------------ the scripts -------------------------------

def _run(pkg, d, text, name):
    path = d / f"in.{name}.{pkg}"
    path.write_text(text)
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    s.variables["nstep"] = str(NSTEP)
    s.file(str(path))
    return s


@pytest.fixture(scope="module")
def waters(tmp_path_factory):
    d = tmp_path_factory.mktemp("av")
    write_data(str(d / "hbond.data"), chip_smoke.hbond_water_layout(81))
    return d


# AV's input; the morse form alone (its zero 2-body table, no k-space)
SCRIPTS = {"AV": chip_smoke.hbond_script("lj"),
           "morse alone": chip_smoke.hbond_script("morse", alone=True)}


@pytest.mark.parametrize("case", list(SCRIPTS))
def test_scripts_match_jax(waters, case):
    ts = _run("torch", waters, SCRIPTS[case], case.replace(" ", "_"))
    js = _run("jax", waters, SCRIPTS[case], case.replace(" ", "_"))
    cols = ("etotal", "ke", "temp", "pe", "evdwl", "ecoul", "elong",
            "ebond", "eangle", "press")
    assert len(ts.thermo_rows) == len(js.thermo_rows) == NSTEP + 1
    chip_smoke.rows_agree(case, ts.thermo_rows, js.thermo_rows,
                          [1e-8] * (NSTEP + 1), cols=cols)
    n = ts._sim.natoms
    for k in ("x", "v"):
        a = getattr(ts._sim.sys, k)[:n].numpy()
        b = np.asarray(getattr(js._sim.sys, k))[:n]
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-8 * np.abs(b).max(), err_msg=k)
    ff = ts._sim.runner.ff
    assert len(ff.hbond) == 1 and int(ff.hbond[0].dh_valid.sum()) == 162
    assert ff.hbond[0].morse == (case != "AV")


def test_hbond_needs_bonds(tmp_path):
    """A system without bonds: both packages raise init_style's error."""
    chip_smoke.write_breadth_data(str(tmp_path / "data.breadth"))
    text = ("units lj\natom_style charge\nread_data data.breadth\n"
            "pair_style hybrid/overlay lj/cut 2.5 hbond/dreiding/lj 4 1.5 "
            "2.0 90\npair_coeff * * lj/cut 1.0 1.0\n"
            "pair_coeff 1 2 hbond/dreiding/lj 1 i 1.0 1.0\nrun 0\n")
    for pkg in ("torch", "jax"):
        with pytest.raises(ValueError, match="molecular system"):
            _run(pkg, tmp_path, text, "nobonds")


def test_hbond_with_exclusions_raises(waters):
    """neigh_modify exclude thins the reference's neighbour list, which
    the JAX package's [M, N] pass does not read (ROADMAP queue 3 item
    40)."""
    text = SCRIPTS["AV"].replace("neighbor 2.0 bin\n",
                                 "neighbor 2.0 bin\nneigh_modify exclude "
                                 "molecule/intra all\n")
    with pytest.raises(NotImplementedError, match="queue 3 item 40"):
        _run("torch", waters, text, "excl")


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_hbond_golden(case, tmp_path):
    """tests/test_hbond.py's 9-atom box through the port: every row at
    that test's bars (rel 1e-8, abs 1e-10) of the rebuilt LAMMPS's."""
    write_golden_data(tmp_path / "data.hb")
    style, coeff = HB_LINE[case]
    (tmp_path / "in.hb").write_text(f"""units real
atom_style full
boundary p p p
read_data {tmp_path}/data.hb
pair_style hybrid/overlay lj/cut 5.0 {style}
pair_coeff 1 1 lj/cut 0.1553 3.166
pair_coeff 2 2 lj/cut 0.0 1.0
pair_coeff 1 2 lj/cut 0.0 2.083
{coeff}
bond_style harmonic
bond_coeff 1 450.0 0.9572
angle_style harmonic
angle_coeff 1 55.0 104.52
special_bonds lj/coul 0.0 0.0 0.5
timestep 0.2
fix 1 all nve
thermo_style custom step temp pe evdwl press
thermo 2
run 8
""")
    s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                             log=lambda line: None)
    s.file(str(tmp_path / "in.hb"))
    got = {int(r["step"]): r for r in s.thermo_rows}
    for ref in GOLDEN[case]:
        r = got[int(ref[0])]
        for name, g in zip(("temp", "pe", "evdwl", "press"), ref[1:]):
            assert float(r[name]) == pytest.approx(g, rel=1e-8, abs=1e-10), (
                f"{case} step {ref[0]} {name}: {r[name]} vs {g}")
