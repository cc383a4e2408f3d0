"""neigh_modify exclude in the port (io/script.py, PairParams.excl and
excl_mol, ops/pair.py's dense pass, ops/cells.py's cell pass, the special
correction skipped under excl_mol) against the JAX package's, float64 on
the CPU, both sides in one process; and two records of the JAX package's
own behaviour that the port does not copy:

  * scripts, 10 steps with a row each step, every thermo column within
    rel 1e-8 of max(1, |value|) of JAX's, the final x and v within 1e-8 of
    their largest entry: `exclude molecule/intra all` and `exclude type 1
    2` on the polar fluid (chip_smoke.fluid_script_case(n_side=5)) on the
    dense route; above a dense cap mocked to 300 (`neighbor 0.1 bin`, a
    3 x 3 x 3 grid) `exclude molecule all` on the point-charge fluid and
    `exclude type 1 2` on the polar fluid (the cell grid and the dense
    polar term), plus chip_smoke.CANCEL_REL of what the special correction
    cancels;
  * cell_pair_forces with excl and excl_mol against JAX's on a seeded
    two-type case: 1e-12 of each output's largest entry;
  * the refusals: exclude group, exclude molecule on a sub-group (breadth),
    and excl_mol on the panel engine (LIDP_FAST_POLAR=1), whose JAX
    counterpart runs without the exclusion: its rows against its own dense
    route's (ROADMAP queue 3 item 12);
  * the JAX package's neighbour list overflows at its first build on a
    cubic box of more than 4,096 atoms under 3 cells of cutoff + skin a
    side (ROADMAP queue 3 item 13): 5,184 uniform atoms in L = 48 at
    c = 16.5 with its defaults, bin_cap 64 and max_neighbors 128.
"""

import dataclasses
import os
from unittest import mock

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin
# on the cores the other workers use (this file and nine like it took
# over 4x as long under -n 6 without the pin; the CPU-thread fault it
# once guarded is repaired, ROADMAP queue 3 item 1)
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu import sim as jsim  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.parallel import fast_polar as tfast  # noqa: E402

NSTEP = 10
MOL = "neigh_modify exclude molecule/intra all\n"
TYPE = "neigh_modify exclude type 1 2\n"
CELLS = "neighbor 0.1 bin\n"


def _with(text, extra):
    return text.replace("read_data fluid.data\n",
                        "read_data fluid.data\n" + extra)


CASES = {
    "dense_mol": _with(chip_smoke.FLUID_SCRIPT, MOL),
    "dense_type": _with(chip_smoke.FLUID_SCRIPT, TYPE),
    "cells_mol": _with(chip_smoke.point_charge_script(),
                       CELLS + MOL.replace("molecule/intra", "molecule")),
    "cells_type": _with(chip_smoke.FLUID_SCRIPT, CELLS + TYPE),
}
CAPPED = {"cells_mol": 300, "cells_type": 300}


def _run(pkg, d, text, nstep=NSTEP, cap=None, fast_polar=None):
    path = d / f"in.{pkg}"
    path.write_text(text)
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    s.variables["nstep"] = str(nstep)
    cap = cap or jsim.DENSE_PATH_MAX_ATOMS
    env = {k: v for k, v in os.environ.items()
           if k not in ("LIDP_FAST_POLAR", "LIDP_FAST_POLAR_MODE")}
    if fast_polar is not None:
        env["LIDP_FAST_POLAR"] = fast_polar
    with mock.patch.dict(os.environ, env, clear=True), \
            mock.patch.object(jsim, "DENSE_PATH_MAX_ATOMS", cap), \
            mock.patch.object(tfast, "DENSE_PATH_MAX_ATOMS", cap):
        s.file(str(path))
    return s


@pytest.fixture(scope="module")
def fluid(tmp_path_factory):
    d = tmp_path_factory.mktemp("fluid")
    chip_smoke.fluid_script_case(str(d), n_side=5)
    return d


@pytest.fixture(scope="module")
def runs(fluid):
    return {case: tuple(_run(pkg, fluid, text, cap=CAPPED.get(case))
                        for pkg in ("jax", "torch"))
            for case, text in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_script_matches_jax(runs, case):
    js, ts = runs[case]
    sim = ts._sim
    pair = sim.runner.ff.pair
    assert type(sim.runner).__name__ == "Runner"
    cells = case in CAPPED
    assert (sim.runner.neighbor_cfg is not None) == cells
    if case.endswith("_mol"):
        assert pair.excl_mol and pair.excl is None
    else:
        assert not pair.excl_mol
        np.testing.assert_array_equal(
            pair.excl.numpy(), np.asarray(js._sim.runner.ff.pair.excl))
    assert len(ts.thermo_rows) == len(js.thermo_rows) == NSTEP + 1
    chip_smoke.rows_agree(case, ts.thermo_rows, js.thermo_rows,
                          [1e-8] * (NSTEP + 1), cols=chip_smoke.G64_COLS,
                          cancel=chip_smoke.cancelled(sim) if cells else None)
    n = sim.natoms
    for k in ("x", "v"):
        a = getattr(sim.sys, k)[:n].numpy()
        b = np.asarray(getattr(js._sim.sys, k))[:n]
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-8 * np.abs(b).max(), err_msg=k)


def test_exclusions_change_the_rows(runs, fluid):
    """The exclusions act: each case's step-0 PE differs from the input's
    without them (the molecule exclusion drops the special pairs' coulomb
    subtraction, whose LJ term is 0 already; the type exclusion the O-H
    pairs' LJ and coulomb terms)."""
    base = _run("torch", fluid, chip_smoke.FLUID_SCRIPT, nstep=0)
    e0 = base.thermo_rows[0]["pe"]
    for case in ("dense_mol", "dense_type"):
        assert abs(runs[case][1].thermo_rows[0]["pe"] - e0) > 1.0


def test_cell_pair_forces_exclusions_match_jax():
    from lidp_tpu.box import Box as JBox
    from lidp_tpu.ops.cells import CellConfig as JCfg
    from lidp_tpu.ops.cells import build_cells as jbuild
    from lidp_tpu.ops.cells import cell_pair_forces as jcell
    from lidp_tpu.ops.pair import make_pair_params as jpair
    from lidp_tpu_torch.box import Box
    from lidp_tpu_torch.ops.cells import CellConfig, build_cells, \
        cell_pair_forces
    from lidp_tpu_torch.ops.pair import make_pair_params

    rng = np.random.RandomState(21)
    L = np.array([10.0, 11.0, 12.0])
    n = 300
    x = rng.uniform(0.0, 1.0, (n, 3)) * L
    q = rng.normal(0.0, 0.3, n)
    type_ = rng.randint(1, 3, n).astype(np.int32)
    mol = (np.arange(n) // 3 + 1).astype(np.int32)
    eps = np.array([[0, 0, 0], [0, 0.2, 0.1], [0, 0.1, 0.05]])
    sig = np.array([[0, 0, 0], [0, 1.0, 1.1], [0, 1.1, 1.2]])
    cut = np.full((3, 3), 2.5)
    excl = np.zeros((3, 3), bool)
    excl[1, 2] = excl[2, 1] = True
    common = dict(cut_coul=3.0, qqrd2e=1.0, g_ewald=0.5, coul=True,
                  excl_types=excl)
    jp = jpair(eps, sig, cut, dtype=jnp.float64, **common)
    tp = make_pair_params(eps, sig, cut, **common)
    cfg = dict(cutneigh=3.0, density=n / np.prod(L), cap_slack=2.0)
    jc = jbuild(jnp.asarray(x), jnp.ones(n, bool),
                JBox.create(np.zeros(3), L, dtype=jnp.float64),
                JCfg.for_box(L, **cfg))
    tbox = Box.create(np.zeros(3), L, dtype=torch.float64)
    tc = build_cells(torch.as_tensor(x), torch.ones(n, dtype=torch.bool),
                     tbox, CellConfig.for_box(L, **cfg))
    for excl_mol in (False, True):
        jpk = dataclasses.replace(jp, excl_mol=excl_mol)
        tpk = dataclasses.replace(tp, excl_mol=excl_mol)
        want = jcell(jnp.asarray(x), jnp.asarray(q), jnp.asarray(type_),
                     jnp.ones(n, bool), jc,
                     JBox.create(np.zeros(3), L, dtype=jnp.float64), jpk,
                     mol=jnp.asarray(mol))
        got = cell_pair_forces(
            torch.as_tensor(x), torch.as_tensor(q), torch.as_tensor(type_),
            torch.ones(n, dtype=torch.bool), tc, tbox, tpk,
            mol=torch.as_tensor(mol))
        for g, w, name in zip(got, want, ("f", "evdwl", "ecoul", "vir")):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g.numpy(), w, rtol=0, atol=1e-12 * max(np.abs(w).max(), 1.0),
                err_msg=f"excl_mol={excl_mol} {name}")


# ---------------------- refusals and reference records ----------------------

UNPORTED = {
    "exclude group": "neigh_modify exclude group all all\n",
    "exclude molecule sub-group": "group few molecule <= 10\n"
                                  "neigh_modify exclude molecule/intra few\n",
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_exclusions_raise(fluid, name):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        _run("torch", fluid, _with(chip_smoke.FLUID_SCRIPT, UNPORTED[name]),
             nstep=1)


def test_panel_engine_refuses_excl_mol(runs, fluid):
    """Under LIDP_FAST_POLAR=1 the port raises on excl_mol, naming ROADMAP
    queue 3 item 12: the JAX package's panel engine runs the input without
    the exclusion, so its rows there are those of its dense route without
    the exclusion, and far from those with it (step 0 of each; the dense
    route with it is the dense_mol case's JAX run)."""
    text = CASES["dense_mol"]
    with pytest.raises(NotImplementedError, match="queue 3 item 12"):
        _run("torch", fluid, text, nstep=1, fast_polar="1")
    panel = _run("jax", fluid, text, nstep=0, fast_polar="1")
    assert type(panel._sim.runner).__name__ == "FastPolarRunner"
    plain = _run("jax", fluid, chip_smoke.FLUID_SCRIPT, nstep=0)
    dense = runs["dense_mol"][0]
    a, b, c = (s.thermo_rows[0]["pe"] for s in (panel, plain, dense))
    print(f"JAX step 0 PE: panel engine with the exclusion {a!r}, dense "
          f"route without it {b!r}, dense route with it {c!r}")
    assert abs(a - b) <= 1e-6 * max(1.0, abs(b))
    assert abs(a - c) > 1.0


def test_jax_neighbor_list_overflows_in_a_small_cubic_box():
    """ROADMAP queue 3 item 13: n > 4096 atoms in a cubic box under 3 cells
    of c a side hold n (4 pi / 3) c^3 / L^3 > 636 neighbours within c on
    average, five times the list's max_neighbors 128."""
    from lidp_tpu.box import Box as JBox
    from lidp_tpu.ops.neighbor import NeighborConfig, build_neighbor_list

    n, L, c = 5184, 48.0, 16.5
    x = np.random.RandomState(0).uniform(0.0, L, (n, 3))
    cfg = NeighborConfig.for_box([L] * 3, c)
    assert cfg.nbins == (2, 2, 2)
    assert (cfg.bin_cap, cfg.max_neighbors) == (64, 128)
    nl = build_neighbor_list(jnp.asarray(x), jnp.ones(n, bool),
                             JBox.create(np.zeros(3), np.full(3, L),
                                         dtype=jnp.float64), cfg)
    mean = n * 4.0 * np.pi / 3.0 * c ** 3 / L ** 3
    print(f"mean neighbours within c: {mean:.1f}; overflow "
          f"{bool(nl.overflow)}")
    assert mean > 5 * cfg.max_neighbors - 10 and bool(nl.overflow)
