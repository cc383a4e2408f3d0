"""The port's multilevel summation (lidp_tpu_torch/ops/msm.py; the msm
coulomb of ops/pair.py and ops/cells.py; kspace_style msm and msm/cg with
lj/cut/coul/msm and lj/charmm/coul/msm from a script) against the JAX
package's, float64 on the CPU, both sides in one process:

  * gamma and dgamma (orders 4-10) equal to JAX's (the same host numpy);
    _phi_poly and _dphi_poly on tensors within 1e-13 of JAX's on arrays;
  * setup_msm's grid, levels, cutoff and per-level kernels (ghat, vhat)
    equal to JAX's, with cutoff/adjust on and off, and
    test_msm_cutoff_adjust_parity's case: grid 4^3, the uncapped cutoff
    8.85111 of the reference's warning, the cutoff 0.499 L;
  * msm_forces on tests/test_msm.py's box (64 charges, L 10, cutoff 4
    adjusted) and on an elongated box (order 8, cutoff 3.5 as given), the
    setup and MSMParams carried across by
    convert.msm_from_numpy: f within 1e-10 of max |f|, elong and the
    virial within rel 1e-10; the port's pair part plus grid part against
    the port's Ewald total at tests/test_msm.py's bar (rel 2e-4);
  * scripts, rows within rel 1e-8 of max(1, |value|) of JAX's, final x
    and v within 1e-8: lj/cut/coul/msm with msm on the 64-atom breadth
    box (scripts/gen_breadth_goldens.write_data; cutoff/adjust yes: 4^3,
    the cutoff pushed to 2.994), with msm/cg the same rows bit for bit;
    on the point-charge fluid's cell grid (fluid_script_case(n_side=5),
    `neighbor 0.1 bin`, cutoff/adjust no, the dense cap mocked to 300);
    lj/charmm/coul/msm on the flexible molecules (flexible_script_case
    2 x 2 x 2, CHARMM bonded terms, SHAKE), 2 steps;
  * the port alone on tests/test_msm.py's LAMMPS rows (32^3, order 10,
    cutoff/adjust no, 5 steps) at that test's tolerances; the JAX test of
    those rows is marked slow for the JAX package's compile, the port's
    run takes about 2 s.
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin on
# the cores the other workers use
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu.ops import msm as jmsm  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.ops import ewald as tewald  # noqa: E402
from lidp_tpu_torch.ops import msm as tmsm  # noqa: E402
from scripts.gen_breadth_goldens import write_data  # noqa: E402
from tests.torch_kspace_cases import (close, fluid_long, run,  # noqa: E402
                                      rows_match, scalar_close)

ORDERS = (4, 6, 8, 10)


@pytest.mark.parametrize("order", ORDERS)
def test_gamma_dgamma_match_jax(order):
    rho = np.linspace(0.0, 2.5, 101)
    np.testing.assert_array_equal(tmsm.gamma(rho, order),
                                  jmsm.gamma(rho, order))
    np.testing.assert_array_equal(tmsm.dgamma(rho, order),
                                  jmsm.dgamma(rho, order))


@pytest.mark.parametrize("order", ORDERS)
def test_phi_polys_match_jax(order):
    xi = np.linspace(-order / 2 - 0.7, order / 2 + 0.7, 203)
    for fn in ("_phi_poly", "_dphi_poly"):
        want = np.asarray(getattr(jmsm, fn)(jnp.asarray(xi), order))
        got = getattr(tmsm, fn)(torch.as_tensor(xi), order)
        assert torch.is_tensor(got)
        close(got, want, 1e-13, fn)
        np.testing.assert_array_equal(getattr(tmsm, fn)(xi, order),
                                      getattr(jmsm, fn)(xi, order))


def _box(seed=11, n=64, L=(10.0, 10.0, 10.0)):
    rs = np.random.RandomState(seed)
    L = np.asarray(L, float)
    x = rs.uniform(0, 1, (n, 3)) * L
    q = rs.normal(size=n)
    return x, q - q.mean(), L


SETUPS = {
    "fixed": (dict(cutoff=4.0, cutoff_adjust=False), (10.0, 10.0, 10.0)),
    "adjust": (dict(cutoff=4.0, cutoff_adjust=True), (10.0, 10.0, 10.0)),
    "box": (dict(cutoff=3.5, cutoff_adjust=False, order=8),
            (9.0, 11.0, 14.0)),
}


def _setup(mod, case, q):
    kw, L = SETUPS[case]
    return mod.setup_msm(accuracy_rel=1e-4, qqrd2e=1.0, q=q, natoms=len(q),
                         box_lengths=L, **kw)


@pytest.mark.parametrize("case", list(SETUPS))
def test_setup_msm_matches_jax(case):
    _, q, _ = _box()
    j, t = _setup(jmsm, case, q), _setup(tmsm, case, q)
    for f in ("order", "cutoff", "grid", "levels", "gamma0", "qscale",
              "cutoff_uncapped"):
        assert getattr(t, f) == getattr(j, f), f
    for a, b in zip(t.ghat + t.vhat, j.ghat + j.vhat):
        np.testing.assert_array_equal(a, b)
    assert len(t.ghat) == len(t.vhat) == t.levels >= 2


def test_cutoff_adjust_parity():
    """tests/test_msm.py test_msm_cutoff_adjust_parity's case through the
    port."""
    q = np.tile([1.0, -1.0], 32)
    kw = dict(accuracy_rel=1e-4, qqrd2e=1.0, q=q, natoms=64, cutoff=2.5,
              box_lengths=[6.0, 6.0, 6.0], cutoff_adjust=True)
    t, j = tmsm.setup_msm(**kw), jmsm.setup_msm(**kw)
    assert t.grid == (4, 4, 4) == j.grid
    assert t.cutoff_uncapped == pytest.approx(8.85111, rel=1e-5)
    assert t.cutoff_uncapped == j.cutoff_uncapped
    assert t.cutoff == pytest.approx(0.499 * 6.0) == j.cutoff


@pytest.fixture(scope="module", params=["adjust", "box"])
def forces_case(request):
    L = SETUPS[request.param][1]
    x, q, L = _box(L=L)
    s = _setup(jmsm, request.param, q)
    want = [np.asarray(v) for v in jmsm.msm_forces(
        jnp.asarray(x), jnp.asarray(q), list(L), s)]
    return x, q, L, s, want


def test_msm_forces_match_jax(forces_case):
    x, q, L, s, (fj, ej, vj) = forces_case
    jp = jmsm.MSMParams.from_setup(s)
    tp = convert.msm_from_numpy(
        {f.name: (tuple(np.asarray(a) for a in getattr(jp, f.name))
                  if f.name in ("ghat", "vhat")
                  else np.asarray(getattr(jp, f.name)))
         for f in dataclasses.fields(jp)}, device="cpu")
    assert (tp.grid, tp.levels, tp.order) == (s.grid, s.levels, s.order)
    got = [tmsm.msm_forces(torch.as_tensor(x), torch.as_tensor(q),
                           torch.as_tensor(L), form)
           for form in (s, tp, tmsm.MSMParams.from_setup(s))]
    for other in got[1:]:
        for a, b in zip(got[0], other):
            assert torch.equal(a, b)
    f, e, vir = got[0]
    assert f.dtype == torch.float64 and f.shape == fj.shape
    close(f, fj, 1e-10, "f")
    scalar_close(e, ej, 1e-10, "elong")
    close(vir, vj, 1e-10, "virial")
    assert np.abs(fj).max() > 1e-2 and np.abs(vj).max() > 1e-2


def test_msm_total_against_ewald():
    """The port's real-space msm pair part plus its grid part against the
    port's Ewald total (real-space erfc + k-space) on tests/test_msm.py's
    box, at that file's bar."""
    from scipy.special import erfc

    x, q, L = _box()
    n = len(q)
    s = _setup(tmsm, "fixed", q)
    d = x[:, None, :] - x[None, :, :]
    d -= L * np.round(d / L)
    iu = np.triu_indices(n, 1)
    r = np.sqrt(np.sum(d * d, axis=-1)[iu])
    qq = (q[:, None] * q[None, :])[iu]
    m = r < 4.0
    e_msm = float(np.sum(qq[m] / r[m] * (1.0 - (r[m] / 4.0)
                                         * tmsm.gamma(r[m] / 4.0, 10))))
    e_msm += float(tmsm.msm_forces(torch.as_tensor(x), torch.as_tensor(q),
                                   torch.as_tensor(L), s)[1])
    es = tewald.setup_ewald_disp(accuracy_rel=1e-8, qqrd2e=1.0, q=q,
                                 natoms=n, cutoff=4.9, box_lengths=L)
    m = r < 4.9
    e_ew = float(np.sum(qq[m] * erfc(es.g_ewald * r[m]) / r[m]))
    e_ew += float(tewald.ewald_forces(
        torch.as_tensor(x), torch.as_tensor(q), float(np.prod(L)),
        tewald.EwaldParams.from_setup(es, 1.0))[1])
    assert e_msm == pytest.approx(e_ew, rel=2e-4), (e_msm, e_ew)


# ------------------------------ the scripts -------------------------------

BREADTH = """\
units lj
atom_style charge
read_data data.breadth
pair_style lj/cut/coul/msm 2.2 2.5
pair_coeff 1 1 1.0 1.0
pair_coeff 2 2 0.8 1.1
kspace_style {kspace} 1.0e-4
{modify}velocity all create 1.0 87287 loop geom
timestep 0.005
fix 1 all nve
thermo 1
run 5
"""
LJ_COLS = ("temp", "pe", "evdwl", "ecoul", "elong", "press")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    d = {k: tmp_path_factory.mktemp(k) for k in ("breadth", "fluid",
                                                  "flex")}
    write_data(str(d["breadth"] / "data.breadth"))
    chip_smoke.fluid_script_case(str(d["fluid"]), n_side=5)
    chip_smoke.flexible_script_case(str(d["flex"]), n_side=(2, 2, 2),
                                    cut=(4.0, 5.5))
    return d


CASES = {
    "breadth": ("breadth", BREADTH.format(kspace="msm", modify=""), None,
                None, LJ_COLS),
    "fluid_cells": ("fluid", fluid_long(
        "lj/cut/coul/msm 6.0 6.5", "msm 1e-4",
        "neighbor 0.1 bin\nkspace_modify cutoff/adjust no\n"), 3, 300,
        chip_smoke.G64_COLS),
    "charmm": ("flex", chip_smoke.flexible_script(
        cut=(4.0, 5.5), pair="lj/charmm/coul/msm 4 5.5", kspace="msm 1e-4"),
        2, None, chip_smoke.FLEX_COLS),
}


@pytest.fixture(scope="module")
def runs(dirs):
    out = {}
    for case, (d, text, nstep, cap, _) in CASES.items():
        logs = []
        js = run("jax", dirs[d], text, nstep=nstep, cap=cap,
                 name=f"{case}.jax")
        ts = run("torch", dirs[d], text, nstep=nstep, cap=cap,
                 name=f"{case}.torch", log=logs.append)
        out[case] = (js, ts, logs)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_script_matches_jax(runs, case):
    js, ts, logs = runs[case]
    ff, jf = ts._sim.runner.ff, js._sim.runner.ff
    assert ff.msm is not None and ff.pair.coul_kind == "msm"
    assert (ff.msm.grid, ff.msm.levels, ff.msm.cutoff) == \
        (tuple(jf.msm.grid), jf.msm.levels, jf.msm.cutoff)
    assert ff.pair.cut_coulsq == float(jf.pair.cut_coulsq)
    assert ff.pair.charmm == (case == "charmm")
    cells = CASES[case][3] is not None
    assert (ts._sim.runner.neighbor_cfg is not None) == cells
    if case == "breadth":
        assert ff.msm.grid == (4, 4, 4)
        assert "Adjusting Coulombic cutoff for MSM, new cutoff = 2.994" \
            in logs
    rows_match(case, ts, js, cols=CASES[case][4],
               cancel=chip_smoke.cancelled(ts._sim) if cells else None)


def test_msm_cg_is_msm(runs, dirs):
    ts = run("torch", dirs["breadth"],
             BREADTH.format(kspace="msm/cg", modify=""), name="cg.torch")
    assert ts.thermo_rows == runs["breadth"][1].thermo_rows


def test_breadth_golden_port(dirs):
    """tests/test_msm.py test_ljmsm_golden_with_press's LAMMPS rows (32^3,
    order 10) through the port at that test's tolerances."""
    ref = {
        0: (1.0, -2.00554866157, -1.42299977076, -0.046983932177,
            -0.535564958637, -0.514594621195),
        5: (1.00633887599, -2.00241169314, -1.4195991171,
            -0.0476721452896, -0.535140430753, -0.50633974749),
    }
    ts = run("torch", dirs["breadth"], BREADTH.format(
        kspace="msm", modify="kspace_modify cutoff/adjust no\n"),
        name="golden.torch")
    assert ts._sim.runner.ff.msm.grid == (32, 32, 32)
    rows = {int(r["step"]): r for r in ts.thermo_rows}
    for step, (temp, pe, ev, ec, el, pr) in ref.items():
        r = rows[step]
        assert r["temp"] == pytest.approx(temp, rel=2e-6)
        assert r["evdwl"] == pytest.approx(ev, rel=2e-6)
        assert r["ecoul"] == pytest.approx(ec, rel=2e-5)
        assert r["elong"] == pytest.approx(el, rel=2e-5)
        assert r["pe"] == pytest.approx(pe, rel=2e-6)
        assert r["press"] == pytest.approx(pr, rel=2e-3)
