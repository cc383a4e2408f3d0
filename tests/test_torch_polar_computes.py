"""The computes on the polar main path (the port's lidp_tpu_torch.api and
sim.py's compute wiring) against the JAX package, float64 on the CPU: the
375-atom polarizable fluid of chip_smoke.fluid_script_case (125 rigid
three-site molecules, lj/cut/coul/long/polarization, ewald/disp, fix
rigid/nve) with compute pe (polarization included, no tail term), ke, com
and gyration and msd of half the molecules, temp/com, group/group between
the two halves, ke/rigid and erotate/rigid, ke/atom reduced by max, pe/atom
reduced by sum, a fix ave/time with a file and fix print, 4 steps and a
row each, then compute rdf through api.lammps.extract_compute.

The port runs it on the dense route (no LIDP_FAST_POLAR) and on the panel
engine (LIDP_FAST_POLAR=1, FastPolarRunner: the output fixes compose with
it).  The JAX package's prescan sends a script with an output fix off its
panel engine whatever LIDP_FAST_POLAR says (ROADMAP queue 3 item 27), so
its reference run is its dense route; every row of both port routes within
rel 1e-8 of max(1, |value|) of JAX's, its ave/time file within rel 1e-8,
its print lines equal, and the rdf array's counts exactly (its g and
coord within rel 1e-12).
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu import api as japi  # noqa: E402
from lidp_tpu_torch import api as tapi  # noqa: E402

REL = 1e-8
COMPUTES = """group half molecule <= 62
group other subtract all half
compute cpe all pe
compute ke1 all ke
compute com1 half com
compute gyr half gyration
compute msd1 half msd
compute tcom half temp/com
compute gg half group/group other
compute kr all ke/rigid 1
compute er all erotate/rigid 1
compute ka all ke/atom
compute mka all reduce max c_ka
compute pa all pe/atom
compute spa all reduce sum c_pa
compute r all rdf 60
variable twice equal 2*c_tcom
fix 2 all ave/time 1 2 2 c_cpe c_gg c_kr file ave.out
fix 3 all print 2 "pe=${pe} step=${step}"
thermo_style custom step etotal ke pe epol c_cpe c_ke1 c_com1[1] c_com1[2] \
c_com1[3] c_gyr c_msd1[4] c_tcom c_gg c_kr c_er c_mka c_spa v_twice
"""
COLS = ("etotal", "ke", "pe", "epol", "c_cpe", "c_ke1", "c_com1[1]",
        "c_com1[2]", "c_com1[3]", "c_gyr", "c_msd1[4]", "c_tcom", "c_gg",
        "c_kr", "c_er", "c_mka", "c_spa", "v_twice")
NSTEP = 4


def _text():
    return chip_smoke.FLUID_SCRIPT.replace(
        "thermo_style custom step etotal ke pe evdwl ecoul elong epol temp "
        "press\n", COMPUTES)


def _run(pkg, work, monkeypatch, fast):
    """The fluid through pkg's api.lammps in work: (script, log lines,
    rdf)."""
    if fast:
        monkeypatch.setenv("LIDP_FAST_POLAR", "1")
    else:
        monkeypatch.delenv("LIDP_FAST_POLAR", raising=False)
    logs = []
    if pkg == "jax":
        L = japi.lammps(cmdargs=["-var", "nstep", str(NSTEP)])
    else:
        L = tapi.lammps(cmdargs=["-var", "nstep", str(NSTEP)], device="cpu")
    s = L.lmp
    s.log = logs.append
    s.root = str(work)
    s.execute(_text().splitlines())
    rdf = L.extract_compute("r")
    monkeypatch.delenv("LIDP_FAST_POLAR", raising=False)
    return s, logs, rdf, (work / "ave.out").read_text()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for name, pkg, fast in (("jax", "jax", False),
                                ("dense", "torch", False),
                                ("panel", "torch", True)):
            work = tmp_path_factory.mktemp(name)
            chip_smoke.fluid_script_case(str(work), n_side=5)
            out[name] = _run(pkg, work, mp, fast)
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("route", ["dense", "panel"])
def test_routes(runs, route):
    runner = type(runs[route][0]._sim.runner).__name__
    assert runner == ("FastPolarRunner" if route == "panel" else "Runner")
    assert type(runs["jax"][0]._sim.runner).__name__ == "Runner"


@pytest.mark.parametrize("route", ["dense", "panel"])
def test_rows_match_jax(runs, route):
    ts, js = runs[route][0], runs["jax"][0]
    assert [r["step"] for r in ts.thermo_rows] == list(range(NSTEP + 1))
    for tr, jr in zip(ts.thermo_rows, js.thermo_rows):
        for k in COLS:
            assert abs(tr[k] - jr[k]) <= REL * max(1.0, abs(jr[k])), (
                route, tr["step"], k, tr[k], jr[k])
    r = ts.thermo_rows[-1]
    # compute pe is the row's pe, polarization included (real units: no
    # norm; no pair_modify tail here)
    assert r["c_cpe"] == r["pe"] and r["epol"] != 0.0
    assert r["c_msd1[4]"] > 0.0 and r["c_gg"] != 0.0


@pytest.mark.parametrize("route", ["dense", "panel"])
def test_outputs_match_jax(runs, route):
    ts, tlog, trdf, tave = runs[route]
    js, jlog, jrdf, jave = runs["jax"]
    assert [w for w in tlog if w.startswith("pe=")] == \
        [w for w in jlog if w.startswith("pe=")]
    tl, jl = tave.splitlines(), jave.splitlines()
    assert len(tl) == len(jl) == NSTEP // 2
    for a, b in zip(tl, jl):
        a, b = np.array(a.split(), float), np.array(b.split(), float)
        assert np.all(np.abs(a - b) <= REL * np.maximum(1.0, np.abs(b)))
    assert trdf.shape == jrdf.shape == (60, 3)
    ng = ts._sim.natoms
    assert np.array_equal(np.round(trdf[:, 2] * ng / 2),
                          np.round(jrdf[:, 2] * ng / 2))
    assert np.abs(trdf - jrdf).max() <= 1e-12 * np.abs(jrdf).max()
