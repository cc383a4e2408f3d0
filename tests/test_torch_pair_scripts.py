"""The other pair styles from a script (lidp_tpu_torch/io/script.py's
grammar, styles/pair_builders.py, sim.py) against LAMMPS's rows and the
JAX package's, float64 on the CPU:

  * every style the JAX interpreter runs but those of ROADMAP queue 1
    item 6.6 (the DREIDING hydrogen bonds, lj/charmmfsw/*,
    lj/charmm/coul/charmm/implicit: their rows against the JAX package's
    here, the rest in tests/test_torch_charmm_family.py and
    test_torch_hbond.py): the port's Simulation.from_script builds the JAX
    package's tables (the JAX ones carried across by
    convert.pair_from_numpy, field by field, rel 1e-14) on
    tests/test_pair_breadth2.py's 64-atom box;
  * the 16 GOLDEN cases of tests/test_pair_breadth2.py (rows of a rebuilt
    16Mar18 LAMMPS, inputs from scripts/gen_breadth_goldens.py) and its
    lj/cubic, lj/gromacs/coul/gromacs and lj/charmm/coul/charmm goldens
    (the dpd one in test_torch_dpd.py): each row at that file's bars, and
    at rel
    1e-8 of max(1, |value|) of the JAX package's rows (final x and v
    within 1e-8); born/coul/msm with msm (whose JAX run is slow-marked)
    at its bars against LAMMPS alone;
  * tests/test_pair_styles.py's dimers (morse, buck, yukawa, gauss, soft,
    born, coul/cut): the closed-form energy at 1e-9, the force against a
    finite difference at 1e-4, Newton's third law;
  * pair_modify tail yes on lj/cut and lj/cut/coul/cut: the rows equal
    JAX's, and the tail moves pe and press by etail/V and ptail/V.
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin on
# the cores the other workers use
torch.set_num_threads(1)

from lidp_tpu import sim as jsim  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch import sim as tsim  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from scripts.gen_breadth_goldens import make_input, write_data  # noqa: E402
from tests.test_pair_breadth2 import GOLDEN, SWITCH_GOLDEN  # noqa: E402

COLS = ("temp", "pe", "evdwl", "ecoul", "press")


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    d = tmp_path_factory.mktemp("breadth")
    write_data(str(d / "data.breadth"))
    write_data(str(d / "data.breadth1"), one_type=True)
    return d


def _run(pkg, d, text, name="case"):
    path = d / f"in.{name}.{pkg}"
    path.write_text(text.replace("read_data data.breadth",
                                 f"read_data {d}/data.breadth"))
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    s.file(str(path))
    return s


def _agree_with_jax(ts, js, cols=COLS):
    """Rows within rel 1e-8 of max(1, |value|) of JAX's, as many rows;
    the final x and v within 1e-8 of their largest entry."""
    assert len(ts.thermo_rows) == len(js.thermo_rows) > 0
    for rt, rj in zip(ts.thermo_rows, js.thermo_rows):
        for c in cols:
            assert abs(rt[c] - rj[c]) <= 1e-8 * max(1.0, abs(rj[c])), (
                int(rj["step"]), c, rt[c], rj[c])
    n = ts._sim.natoms
    for k in ("x", "v"):
        a = getattr(ts._sim.sys, k)[:n].numpy()
        b = np.asarray(getattr(js._sim.sys, k))[:n]
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-8 * np.abs(b).max(), err_msg=k)


# --------------------------- the builders --------------------------------

HEAD = """units lj
atom_style charge
read_data data.breadth
"""
# style -> the lines after read_data (every style the JAX interpreter
# knows but item 6.6's; table in its own test)
BORN = ("pair_coeff 1 1 1.0 0.4 1.0 1.0 0.5\n"
        "pair_coeff 1 2 0.9 0.45 1.05 1.0 0.5\n"
        "pair_coeff 2 2 0.8 0.5 1.1 1.0 0.5\n")
BUCK = ("pair_coeff 1 1 100.0 0.3 1.0\npair_coeff 1 2 90.0 0.32 0.9\n"
        "pair_coeff 2 2 80.0 0.35 0.8\n")
LJ = "pair_coeff 1 1 1.0 1.0\npair_coeff 2 2 0.8 1.1\n"
EWALD = "kspace_style ewald 1e-5\n"
MSM = "kspace_style msm 1e-4\nkspace_modify cutoff/adjust no\n"
BUILD = {
    "morse": "pair_style morse 2.5\npair_coeff * * 1.0 1.5 1.1\n",
    "buck": "pair_style buck 2.5\n" + BUCK,
    "buck/coul/cut": "pair_style buck/coul/cut 2.2 2.5\n" + BUCK,
    "buck/coul/long": "pair_style buck/coul/long 2.2 2.5\n" + BUCK + EWALD,
    "buck/coul/msm": "pair_style buck/coul/msm 2.2 2.5\n" + BUCK + MSM,
    "yukawa": "pair_style yukawa 1.5 2.5\npair_coeff * * 2.0\n",
    "gauss": "pair_style gauss 2.5\npair_coeff * * 1.5 0.8\n",
    "soft": "pair_style soft 1.2\npair_coeff * * 3.0\n",
    "born": "pair_style born 2.5\n" + BORN,
    "born/coul/long": "pair_style born/coul/long 2.2 2.5\n" + BORN + EWALD,
    "born/coul/dsf": "pair_style born/coul/dsf 0.5 2.2 2.5\n" + BORN,
    "born/coul/wolf": "pair_style born/coul/wolf 0.5 2.2 2.5\n" + BORN,
    "born/coul/msm": "pair_style born/coul/msm 2.2 2.5\n" + BORN + MSM,
    "coul/cut": "pair_style coul/cut 2.5\npair_coeff * *\n",
    "coul/long": "pair_style coul/long 2.5\npair_coeff * *\n" + EWALD,
    "coul/msm": "pair_style coul/msm 2.5\npair_coeff * *\n" + MSM,
    "coul/debye": "pair_style coul/debye 1.5 2.5\npair_coeff * *\n",
    "coul/dsf": "pair_style coul/dsf 0.5 2.5\npair_coeff * *\n",
    "coul/wolf": "pair_style coul/wolf 0.5 2.5\npair_coeff * *\n",
    "lj/expand": "pair_style lj/expand 2.5\npair_coeff * * 1.0 1.0 0.2\n",
    "mie/cut": ("pair_style mie/cut 2.5\npair_coeff 1 1 1.0 1.0 12 6\n"
                "pair_coeff 2 2 0.8 1.1 14 7\n"),
    "lj/gromacs": "pair_style lj/gromacs 1.8 2.5\n" + LJ,
    "lj/gromacs/coul/gromacs": ("pair_style lj/gromacs/coul/gromacs 1.8 "
                                "2.2 1.9 2.4\n" + LJ),
    "beck": "pair_style beck 2.5\npair_coeff * * 5.0 1.0 0.9 3.0 0.2\n",
    "zero": "pair_style zero 2.5\npair_coeff * *\n",
    "lj96/cut": "pair_style lj96/cut 2.5\n" + LJ,
    "lj/smooth/linear": "pair_style lj/smooth/linear 2.5\n" + LJ,
    "lj/sf": "pair_style lj/sf 2.5\n" + LJ,
    "lj/smooth": ("pair_style lj/smooth 2.0 2.5\npair_coeff 1 1 1.0 1.0\n"
                  "pair_coeff 2 2 0.8 1.1 1.9 2.4\n"),
    "ufm": "pair_style ufm 2.5\npair_coeff 1 1 2.0 1.2\n"
           "pair_coeff 2 2 1.5 1.4\n",
    "zbl": ("pair_style zbl 2.0 2.5\npair_coeff 1 1 13 13\n"
            "pair_coeff 1 2 13 29\npair_coeff 2 2 29 29\n"),
    "lj/cubic": "pair_style lj/cubic\n" + LJ,
    "lj/cut/coul/cut": "pair_style lj/cut/coul/cut 2.5 2.2\n" + LJ,
    "lj/cut/coul/debye": "pair_style lj/cut/coul/debye 1.5 2.5\n" + LJ,
    "lj/cut/coul/dsf": "pair_style lj/cut/coul/dsf 0.5 2.2 2.5\n" + LJ,
    "lj/cut/coul/wolf": "pair_style lj/cut/coul/wolf 0.5 2.5\n" + LJ,
    "shift": "pair_style morse 2.5\npair_coeff * * 1.0 1.5 1.1\n"
             "pair_modify shift yes\n",
    "dpd": "pair_style dpd 1.0 2.0 48291\npair_coeff 1 1 25.0 4.5\n"
           "pair_coeff 1 2 30.0 4.5 1.8\npair_coeff 2 2 20.0 4.0\n",
    "dpd/tstat": "pair_style dpd/tstat 1.0 2.0 2.0 9341\n"
                 "pair_coeff * * 4.5\n",
    "hybrid": ("pair_style hybrid lj/cut 2.5 morse 3.0 coul/wolf 0.5 2.4\n"
               "pair_coeff 1 1 lj/cut 1.0 1.0\npair_coeff 1 2 lj/cut 0.9 "
               "1.05\npair_coeff 2 2 morse 2.0 1.5 1.2\n"
               "pair_coeff * * coul/wolf\n"),
    "hybrid/overlay": ("pair_style hybrid/overlay lj/cut/coul/long 2.5 "
                       "born 2.2 lj/cut 2.0\n"
                       "pair_coeff * * lj/cut/coul/long 1.0 1.0\n"
                       "pair_coeff 1 2 born 0.9 0.45 1.05 1.0 0.5\n"
                       "pair_coeff 1 1 lj/cut 0.5 1.0\n"
                       "pair_coeff 2 2 lj/cut 0.4 1.1\n" + EWALD),
}


def _pair_tables(sim):
    """The force field's pair tables (the first, the hybrid's others) and
    DPDParams, the JAX ones as numpy field dicts."""
    ff = sim.runner.ff
    return [ff.pair] + list(ff.extra_pairs), ff.dpd


def _same(a, b, what):
    if b is None:
        assert a is None, what
    elif isinstance(b, torch.Tensor):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-14,
                                   atol=1e-300, err_msg=what)
    elif isinstance(b, tuple):
        np.testing.assert_allclose(a, b, rtol=1e-14, err_msg=what)
    elif isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-14), what
    else:
        assert a == b, what


@pytest.mark.parametrize("style", list(BUILD))
def test_builders_match_jax(box, style):
    text = HEAD + BUILD[style] + "fix 1 all nve\n"
    name = f"b{list(BUILD).index(style)}"
    js = _run("jax", box, text + "timestep 0.005\n", name)
    ts = _run("torch", box, text + "timestep 0.005\n", name)
    jsm = jsim.Simulation.from_script(js)
    tsm = tsim.Simulation.from_script(ts)
    jpairs, jdpd = _pair_tables(jsm)
    tpairs, tdpd = _pair_tables(tsm)
    assert len(jpairs) == len(tpairs)
    for k, (pj, pt) in enumerate(zip(jpairs, tpairs)):
        if pj is None:
            assert pt is None
            continue
        ref = convert.pair_from_numpy(
            {f.name: (None if getattr(pj, f.name) is None
                      else np.asarray(getattr(pj, f.name)))
             for f in dataclasses.fields(pj)}, device="cpu",
            dtype=torch.float64)
        for f in dataclasses.fields(ref):
            _same(getattr(pt, f.name), getattr(ref, f.name),
                  f"{style} sub-style {k} {f.name}")
    if jdpd is not None:
        ref = convert.dpd_from_numpy(
            {f.name: np.asarray(getattr(jdpd, f.name))
             for f in dataclasses.fields(jdpd)}, device="cpu")
        for f in dataclasses.fields(ref):
            _same(getattr(tdpd, f.name), getattr(ref, f.name),
                  f"{style} dpd {f.name}")
    else:
        assert tdpd is None
    assert ts.pair.cut_coul == js.pair.cut_coul


# the styles ROADMAP queue 1 item 6.6 ported, once refused here: style ->
# the lines after pair_style (None: the JAX package's own error on this
# box, which has no bonds)
ITEM_6_6 = {
    "lj/charmm/coul/charmm/implicit 1.8 2.2 1.9 2.4": LJ,
    "hybrid lj/cut 2.5 hbond/dreiding/lj 4 6 6.5 90": None,
    "lj/charmmfsw/coul/long 1.8 2.2": LJ + EWALD,
}


@pytest.mark.parametrize("style", list(ITEM_6_6))
def test_item_6_6_styles_raise(box, style):
    """The styles of ROADMAP queue 1 item 6.6, which raised naming it
    until the item was ported: their rows equal the JAX package's at rel
    1e-8 (the hydrogen bonds raise the JAX package's ValueError on this
    box without bonds, in both packages; tests/test_torch_hbond.py runs
    them)."""
    lines = ITEM_6_6[style]
    if lines is None:
        text = (HEAD + f"pair_style {style}\npair_coeff * * lj/cut 1.0 1.0\n"
                "pair_coeff 1 2 hbond/dreiding/lj 1 i 1.0 1.0\n" + SWITCH_RUN)
        for pkg in ("torch", "jax"):
            with pytest.raises(ValueError, match="molecular system"):
                _run(pkg, box, text, "hb")
        return
    text = HEAD + f"pair_style {style}\n" + lines + SWITCH_RUN
    _agree_with_jax(_run("torch", box, text, "i66"),
                    _run("jax", box, text, "i66"))


# ------------------------------- goldens ---------------------------------

def _golden_rows(s, ref, case, bars=dict(rel=2e-6, abs=5e-8), cols=COLS):
    got = {int(r["step"]): r for r in s.thermo_rows}
    for row in ref:
        r = got[int(row[0])]
        for name, g in zip(cols, row[1:]):
            assert r[name] == pytest.approx(g, **bars), (case, row[0], name)


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_breadth_goldens(box, case):
    text = make_input(case)
    ts = _run("torch", box, text, case)
    _golden_rows(ts, GOLDEN[case], case)
    _agree_with_jax(ts, _run("jax", box, text, case))


SWITCH_RUN = """velocity all create 1.0 87287 loop geom
timestep 0.005
fix 1 all nve
thermo 5
run 5
"""


@pytest.mark.parametrize("style", ["lj/charmm/coul/charmm 1.8 2.2 1.9 2.4",
                                   "lj/gromacs/coul/gromacs 1.8 2.2 1.9 2.4"])
def test_switched_coul_goldens(box, style):
    text = (HEAD + f"pair_style {style}\npair_coeff 1 1 1.0 1.0\n"
            "pair_coeff 2 2 0.8 1.1\n" + SWITCH_RUN)
    ts = _run("torch", box, text, "switch")
    got = {int(r["step"]): r for r in ts.thermo_rows}
    for step, ref in SWITCH_GOLDEN[style].items():
        for name, g in zip(COLS, ref):
            rel = 2e-5 if name == "press" else 2e-6
            assert got[step][name] == pytest.approx(g, rel=rel), (step, name)
    _agree_with_jax(ts, _run("jax", box, text, "switch"))


def test_lj_cubic_golden(box):
    text = (HEAD.replace("data.breadth", "data.breadth1")
            + "pair_style lj/cubic\npair_coeff 1 1 1.0 0.9\n" + SWITCH_RUN)
    ts = _run("torch", box, text, "cubic")
    got = {int(r["step"]): r for r in ts.thermo_rows}
    ref = {0: (1.0, -0.0930752815007, -0.00642528900636),
           5: (1.01597648147, -0.116698313029, -0.00423792546084)}
    for step, (temp, pe, pr) in ref.items():
        assert got[step]["temp"] == pytest.approx(temp, rel=2e-6)
        assert got[step]["pe"] == pytest.approx(pe, rel=2e-6)
        assert got[step]["press"] == pytest.approx(pr, rel=2e-5, abs=1e-8)
    _agree_with_jax(ts, _run("jax", box, text, "cubic"))


def test_born_coul_msm_golden(box):
    """born/coul/msm with msm 1e-4, cutoff/adjust no: the port's rows at
    tests/test_pair_breadth2.py's bars (its JAX run is slow-marked; the
    msm and born terms are held to JAX's in test_torch_pair_generic.py
    and test_torch_msm.py)."""
    text = HEAD + "pair_style born/coul/msm 2.2 2.5\n" + BORN + MSM \
        + SWITCH_RUN
    ts = _run("torch", box, text, "msm")
    got = {int(r["step"]): r for r in ts.thermo_rows}
    ref = {0: (1.0, 0.630733487567, 1.21328236779, -0.0469839215897,
               -0.535564958637, 0.638255904458),
           5: (0.998847410872, 0.615083017909, 1.19789009871,
               -0.0476639127873, -0.535143168018, 0.629331053972)}
    for step, (temp, pe, ev, ec, el, pr) in ref.items():
        r = got[step]
        assert r["temp"] == pytest.approx(temp, rel=2e-6)
        assert r["evdwl"] == pytest.approx(ev, rel=2e-6)
        assert r["ecoul"] == pytest.approx(ec, rel=2e-5)
        assert r["elong"] == pytest.approx(el, rel=2e-5)
        assert r["pe"] == pytest.approx(pe, rel=2e-5)
        assert r["press"] == pytest.approx(pr, rel=2e-3)


# ------------------------------- dimers ----------------------------------

def _dimer(lines, r=1.5, q=(0.0, 0.0)):
    """tests/test_pair_styles.py's dimer through the port: two atoms r
    apart on x in a 20^3 box, `run 0`."""
    s = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    atom_style = "atomic" if q == (0.0, 0.0) else "full"
    s.execute(f"""units lj
atom_style {atom_style}
boundary p p p
region box block 0 20 0 20 0 20 units box
create_box 1 box
""".strip().splitlines() + lines.strip().splitlines())
    n = 2
    s.x = np.array([[5.0, 5.0, 5.0], [5.0 + r, 5.0, 5.0]])
    s.v = np.zeros((n, 3))
    s.q = np.array(q, float)
    s.type = np.ones(n, np.int32)
    s.mol = np.zeros(n, np.int32)
    s.image = np.zeros((n, 3), np.int32)
    s._bonds = np.zeros((0, 2), np.int64)
    s.groups["all"] = np.ones(n, bool)
    s.mass_type = np.array([0.0, 1.0])
    s.alpha_type = np.zeros(2)
    s.one("fix 1 all nve")
    s.one("run 0")
    return s.thermo_rows[-1], s._sim.res.f.numpy()


DIMERS = {
    "morse": ("pair_style morse 5.0\npair_coeff 1 1 2.0 1.5 1.2",
              lambda r: 2.0 * (np.exp(-2 * 1.5 * (r - 1.2))
                               - 2 * np.exp(-1.5 * (r - 1.2)))),
    "buck": ("pair_style buck 5.0\npair_coeff 1 1 100.0 0.5 2.0",
             lambda r: 100.0 * np.exp(-r / 0.5) - 2.0 / r**6),
    "yukawa": ("pair_style yukawa 1.8 5.0\npair_coeff 1 1 3.0",
               lambda r: 3.0 * np.exp(-1.8 * r) / r),
    "gauss": ("pair_style gauss 5.0\npair_coeff 1 1 2.5 0.8",
              lambda r: -2.5 * np.exp(-0.8 * r * r)),
    "soft": ("pair_style soft 5.0\npair_coeff 1 1 4.0",
             lambda r: 4.0 * (1.0 + np.cos(np.pi * r / 5.0))),
    "born": ("pair_style born 5.0\npair_coeff 1 1 50.0 0.4 1.0 2.0 1.5",
             lambda r: (50.0 * np.exp((1.0 - r) / 0.4) - 2.0 / r**6
                        + 1.5 / r**8)),
    "coul/cut": ("pair_style coul/cut 5.0\npair_coeff * *",
                 lambda r: 0.8 * (-0.5) / r),
}


@pytest.mark.parametrize("name", list(DIMERS))
def test_dimers(name):
    lines, eref = DIMERS[name]
    q = (0.8, -0.5) if name == "coul/cut" else (0.0, 0.0)
    r, h = 1.5, 1e-6
    row, f = _dimer(lines, r, q)
    # lj units: E_pair per atom (2 atoms)
    assert abs(row["epair"] * 2 - eref(r)) < 1e-9 * max(1, abs(eref(r)))
    ep, _ = _dimer(lines, r + h, q)
    em, _ = _dimer(lines, r - h, q)
    fd = (ep["epair"] - em["epair"]) * 2 / (2 * h)
    assert abs(f[0, 0] - fd) < 1e-4 * max(1.0, abs(fd)), (f[0, 0], fd)
    assert abs(f[0, 0] + f[1, 0]) < 1e-10


# ---------------------------- pair_modify tail ----------------------------

@pytest.mark.parametrize("style", ["lj/cut 2.5", "lj/cut/coul/cut 2.5"])
def test_pair_modify_tail(box, style):
    base = (HEAD + f"pair_style {style}\n" + LJ + "pair_coeff 1 2 0.9 1.05 "
            "2.2\nvelocity all create 1.0 87287 loop geom\ntimestep 0.005\n"
            "fix 1 all nve\nthermo 1\nrun 2\n")
    tail = base.replace("pair_coeff 1 1", "pair_modify tail yes\n"
                        "pair_coeff 1 1")
    ts = _run("torch", box, tail, "tail")
    _agree_with_jax(ts, _run("jax", box, tail, "tail"))
    plain = _run("torch", box, base, "notail")
    tp = ts._sim.thermo_params
    assert tp.etail < 0 and tp.ptail < 0
    vol = 216.0
    r0, p0 = ts.thermo_rows[0], plain.thermo_rows[0]
    # lj units normalize pe per atom
    assert r0["pe"] - p0["pe"] == pytest.approx(tp.etail / vol / 64,
                                                rel=1e-10)
    assert r0["press"] < p0["press"]


# ----------------------- the computes on the new kinds --------------------

COMPUTES = """group one type 1
group two type 2
compute pa all pe/atom
compute sa all stress/atom NULL
compute rs all reduce sum c_pa c_sa[1] c_sa[4]
compute gg one group/group two
velocity all create 1.0 87287 loop geom
timestep 0.005
fix 1 all nve
thermo 1
thermo_style custom step pe c_rs[1] c_rs[2] c_rs[3] c_gg
run 1
"""


@pytest.mark.parametrize("style", ["born/coul/wolf", "hybrid"])
def test_computes_take_the_new_kinds(box, style):
    """compute pe/atom, stress/atom (reduced) and group/group through
    ops/pair.py pair_single on the new kinds (the hybrid's first
    sub-style, as the JAX package takes it): the port's columns at rel
    1e-8 of max(1, |value|) of JAX's (ROADMAP queue 3 item 28's forms)."""
    text = HEAD + BUILD[style] + COMPUTES
    ts = _run("torch", box, text, "comp")
    js = _run("jax", box, text, "comp")
    cols = ("pe", "c_rs[1]", "c_rs[2]", "c_rs[3]", "c_gg")
    _agree_with_jax(ts, js, cols=cols)
    assert abs(ts.thermo_rows[0]["c_gg"]) > 0.0


@pytest.mark.parametrize("style", ["born 2.5", "hybrid lj/cut 2.5"])
def test_pair_modify_tail_elsewhere_raises(box, style):
    """pair_modify tail yes outside the lj/cut family: the JAX package
    adds no tail there (ROADMAP queue 3 item 37); the port raises."""
    coeff = ("pair_coeff * * 1.0 0.4 1.0 1.0 0.5" if style.startswith("born")
             else "pair_coeff * * lj/cut 1.0 1.0")
    text = (HEAD + f"pair_style {style}\n{coeff}\npair_modify tail yes\n"
            "fix 1 all nve\nrun 0\n")
    with pytest.raises(NotImplementedError, match="queue 3 item 37"):
        _run("torch", box, text, "tailx")
