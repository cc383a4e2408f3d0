"""The port's atomic front end and cell-grid route (lidp_tpu_torch
io/script.py lattice, region, create_box, create_atoms, neigh_modify,
pair_style lj/cut and lj/cut/coul/long; sim.py's cell grid above the dense
cap; ops/bonded.special_correction_sparse; forcefield.compute_forces on
Cells with the Ewald sum and the polar term) against the JAX package's,
float64 on the CPU unless named, both sides in one process.

  * the state after lattice / region / create_box / create_atoms /
    velocity (loop geom and loop all, `set` in lattice units): x, v,
    type and the box equal to JAX's LammpsScript bit for bit;
  * bench/in.lj (chip_smoke.LJ_SCRIPT) with its region cut to 5 lattice
    cells a side (500 atoms, the dense route) and to 11 (5,324 atoms, the
    cell grid), 20 steps, a row every 5, under its own `every 20 check no`
    and under `every 1 delay 0 check yes`: rows within rel 1e-8 of max(1,
    |value|), the final x and v within 1e-8 of their largest entry; with
    --f32 at 11 the pair route is cell_pair_forces_lj (on the CPU its
    plain twin) and the rows agree with JAX's float64 rows at rel 1e-5
    (float32 rounding over 20 steps);
  * special_correction_sparse against JAX's on a seeded case with special
    lists at levels 1-3: 1e-12 of each output's largest entry;
  * compute_forces on a cell grid with Ewald, and with Ewald and the polar
    term, against JAX's: 1e-8 of each output's largest entry (the energies
    of the largest energy), the same CG iteration count;
  * the point-charge fluid (chip_smoke.point_charge_script on
    fluid_script_case(n_side=5)) on the dense route, and with `neighbor 0.1
    bin` above a dense cap mocked to 300 on the cell grid (3 x 3 x 3),
    3 steps: rows within rel 1e-8 of max(1, |value|) plus, on the cell
    grid, chip_smoke.CANCEL_REL of the magnitude the special correction
    cancels (chip_smoke.cancelled: the O-H pairs' LJ term, 5.4e8 in all,
    is added at full weight and subtracted again, as in the JAX package),
    the final x and v within 1e-8 of their largest entry;
  * in.melt (chip_smoke.MELT_SCRIPT) cut to 5 cells a side, 100 steps: its
    `dump atom` frames equal JAX's text;
  * the port's CLI as a subprocess (`-device cpu`) on in.lj cut to 5
    cells, in.melt cut the same way and the point-charge fluid, logged at
    16 digits, against the JAX package's script engine on the same input
    in this process: rows within rel 1e-8 of max(1, |value|);
  * what still raises, naming its ROADMAP item.
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
# one torch thread, for time: under pytest-xdist torch's threads spin
# on the cores the other workers use (this file and nine like it took
# over 4x as long under -n 6 without the pin; the CPU-thread fault it
# once guarded is repaired, ROADMAP queue 3 item 1); so the CLI processes
# it starts run with OMP_NUM_THREADS=1
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu import sim as jsim  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.parallel import fast_polar as tfast  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LJ_COLS = ("temp", "epair", "etotal", "press")
ROWS = 1e-8
STATE = 1e-8
EVERY20 = "delay 0 every 20 check no"
CHECK = "every 1 delay 0 check yes"


def lj_text(schedule=EVERY20, nrun=20, every=5):
    """LJ_SCRIPT with a row every `every` steps, `run nrun` and the
    neigh_modify keywords `schedule`."""
    t = chip_smoke.LJ_SCRIPT.replace("neigh_modify\tdelay 0 every 20 check no",
                                     "neigh_modify\t" + schedule)
    return t.replace("run\t\t100", f"thermo {every}\nrun {nrun}")


def lj_side(side):
    """-var x y z that cut LJ_SCRIPT's region to `side` cells a side."""
    return {k: repr(side / 20) for k in "xyz"}


def melt_text(side=5, nrun=100):
    t = chip_smoke.MELT_SCRIPT.replace("block 0 10 0 10 0 10",
                                       f"block 0 {side} 0 {side} 0 {side}")
    return t.replace("run\t\t250", f"run {nrun}")


def _run(pkg, text, directory, variables=None, dtype64=True, env=None,
         cap=None):
    """`text` through pkg's LammpsScript in `directory` (the port on the
    CPU), with DENSE_PATH_MAX_ATOMS mocked to `cap` in both packages
    where given: the script and its log lines."""
    path = Path(directory) / f"in.{pkg}"
    path.write_text(text)
    lines = []
    if pkg == "jax":
        s = jscript.LammpsScript(
            dtype=jnp.float64 if dtype64 else jnp.float32, log=lines.append)
    else:
        s = tscript.LammpsScript(
            dtype=torch.float64 if dtype64 else torch.float32, device="cpu",
            log=lines.append)
    s.variables.update(variables or {})
    cap = cap or jsim.DENSE_PATH_MAX_ATOMS
    with mock.patch.dict(os.environ, env or {}), \
            mock.patch.object(jsim, "DENSE_PATH_MAX_ATOMS", cap), \
            mock.patch.object(tfast, "DENSE_PATH_MAX_ATOMS", cap):
        if not (env or {}).get("LIDP_FAST_POLAR"):
            os.environ.pop("LIDP_FAST_POLAR", None)
        s.file(str(path))
    return s, lines


def _both(text, directory, **kw):
    return (_run("jax", text, directory, **kw)[0],
            _run("torch", text, directory, **kw)[0])


def _rows_close(ts, js, cols, rel, cancel=None):
    assert len(ts.thermo_rows) == len(js.thermo_rows) > 1
    chip_smoke.rows_agree("script", ts.thermo_rows, js.thermo_rows,
                          [rel] * len(js.thermo_rows), cols=cols,
                          cancel=cancel)
    for r, g in zip(ts.thermo_rows, js.thermo_rows):
        assert int(r["step"]) == int(g["step"])


def _cfg(c):
    """A CellConfig (either package's) as a tuple, None as None."""
    return None if c is None else (tuple(c.nbins), c.cap, c.cutneigh)


def _state_close(ts, js, rel=STATE):
    n = ts._sim.natoms
    for k in ("x", "v"):
        a = getattr(ts._sim.sys, k)[:n].double().numpy()
        b = np.asarray(getattr(js._sim.sys, k), np.float64)[:n]
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max(),
                                   err_msg=k)


# ------------------------------ front end -------------------------------

REGIONS = """\
units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 6 0 6 0 6
create_box 2 box
region slab block INF INF INF INF 0 2 side out
create_atoms 1 region slab
region ball block 1.0 3.0 1.0 3.0 0.2 1.5 units box
create_atoms 2 region ball
create_atoms 2 single 0.25 0.25 0.25
create_atoms 1 single 5.0 5.0 5.0 units box
mass 1 1.0
mass 2 2.0
velocity all create 2.0 4928 loop geom
velocity all set 0.1 NULL -0.2
"""

FRONT = {
    "in.lj": (lambda: lj_text(), lj_side(5)),
    "in.melt": (lambda: melt_text(), {}),
    "regions": (lambda: REGIONS, {}),
}


@pytest.mark.parametrize("name", list(FRONT))
def test_front_end_state_matches_jax(tmp_path, name):
    """The host state before the first run, bit for bit: lattice sites in
    create_atoms_bounds' order, so velocity's loop all stream (in.melt)
    and loop geom hashes (in.lj, regions) give JAX's v."""
    text, variables = FRONT[name]
    text = "\n".join(line for line in text().splitlines()
                     if not line.startswith(("run", "dump")))
    logs = {}
    for pkg in ("jax", "torch"):
        s, lines = _run(pkg, text, tmp_path, variables=variables)
        logs[pkg] = (s, lines)
    (js, jl), (ts, tl) = logs["jax"], logs["torch"]
    assert ts._sim is None and len(ts.x) > 100
    for k in ("x", "v", "type", "box_lo", "box_hi"):
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k), k)
    assert np.abs(ts.v).max() > 0
    assert tl == jl      # the Lattice spacing and Created lines


# ------------------------------- in.lj ----------------------------------

LJ_CASES = {"dense_every20": (5, EVERY20), "dense_check": (5, CHECK),
            "cells_every20": (11, EVERY20), "cells_check": (11, CHECK)}


@pytest.fixture(scope="module")
def jax_lj(tmp_path_factory):
    """JAX's float64 run of lj_text(schedule) at `side` cells, once per
    module: jax_lj(side, schedule)."""
    done = {}

    def get(side, schedule):
        if (side, schedule) not in done:
            d = tmp_path_factory.mktemp("jax_lj")
            done[side, schedule] = _run("jax", lj_text(schedule), d,
                                        variables=lj_side(side))[0]
        return done[side, schedule]

    return get


@pytest.mark.parametrize("name", list(LJ_CASES))
def test_lj_bench_rows_match_jax(jax_lj, tmp_path, name):
    from lidp_tpu_torch.forcefield import pair_route

    side, schedule = LJ_CASES[name]
    js = jax_lj(side, schedule)
    ts = _run("torch", lj_text(schedule), tmp_path,
              variables=lj_side(side))[0]
    assert ts._sim.natoms == js._sim.natoms == 4 * side ** 3
    jr, tr = js._sim.runner, ts._sim.runner
    assert _cfg(tr.neighbor_cfg) == _cfg(jr.neighbor_cfg)
    assert (tr.rebuild_every, tr.check, tr.delay, tr.skin) == (
        jr.rebuild_every, jr.check, jr.delay, jr.skin)
    if name.startswith("cells"):
        assert tr.neighbor_cfg.nbins == (6, 6, 6)
        assert pair_route(ts._sim.sys, tr.ff,
                          ts._sim.nlist.nlist) == "cell_pair_forces"
        assert not bool(ts._sim.nlist.overflow)
    else:
        assert tr.neighbor_cfg is None
    assert len(ts.thermo_rows) == 5
    _rows_close(ts, js, LJ_COLS, ROWS)
    _state_close(ts, js)


def test_lj_bench_float32_takes_the_lj_kernel_route(jax_lj, tmp_path):
    """--f32 on the cell grid: the pair route of the kernel's gate (its
    plain twin on the CPU); rows at rel 1e-5 of JAX's float64 rows (the
    cells_every20 case's run).  (JAX's own float32 rows are no reference
    at that bar: its plain cell pass sums the float32 pair energies to
    1.4e-4 of E_pair at step 0, where the port's sum, like the reference
    log, is within 2e-7.)"""
    from lidp_tpu_torch.forcefield import pair_route

    js = jax_lj(11, EVERY20)
    ts = _run("torch", lj_text(), tmp_path, variables=lj_side(11),
              dtype64=False)[0]
    assert ts._sim.sys.x.dtype == torch.float32
    assert pair_route(ts._sim.sys, ts._sim.runner.ff,
                      ts._sim.nlist.nlist) == "cell_pair_forces_lj"
    _rows_close(ts, js, LJ_COLS, 1e-5)


# --------------------------- the correction -----------------------------

def _special_case(seed=5, nmol=40, L=(14.0, 15.0, 16.0)):
    """nmol 4-site chains on random sites (bonds 1-2, 2-3, 3-4: levels 1,
    2 and 3), two types, charges, 3 masked atoms."""
    rng = np.random.RandomState(seed)
    L = np.asarray(L)
    x0 = rng.uniform(0, 1, (nmol, 3)) * L
    steps = rng.normal(0, 0.6, (nmol, 3, 3)) + np.array([1.0, 0.0, 0.0])
    x = np.concatenate([x0[:, None], x0[:, None] + np.cumsum(steps, 1)],
                       1).reshape(-1, 3)
    n = x.shape[0]
    typ = np.tile([1, 2, 2, 1], nmol)
    q = rng.normal(0, 0.4, n)
    mask = np.ones(n, bool)
    mask[rng.choice(n, 3, replace=False)] = False
    bonds = np.array([(4 * m + k, 4 * m + k + 1) for m in range(nmol)
                      for k in (1, 2, 3)])
    return dict(x=x, q=q, type=typ, mask=mask, L=L, bonds=bonds, n=n)


def _tables(coul, special, cut_lj=(4.0, 4.5), cut_coul=4.5, g_ewald=0.0):
    from lidp_tpu.ops import pair as jpair

    from lidp_tpu_torch import convert

    eps = np.zeros((3, 3))
    sig = np.zeros((3, 3))
    cut = np.zeros((3, 3))
    eps[1:, 1:] = [[0.1, 0.05], [0.05, 0.03]]
    sig[1:, 1:] = [[3.0, 2.7], [2.7, 2.5]]
    cut[1:, 1:] = [[cut_lj[1], cut_lj[0]], [cut_lj[0], cut_lj[0]]]
    sp = (1.0,) + tuple(special)
    pj = jpair.make_pair_params(eps, sig, cut, cut_coul=cut_coul, coul=coul,
                                qqrd2e=332.06371, g_ewald=g_ewald,
                                special_lj=sp, special_coul=sp,
                                dtype=jnp.float64)
    fields = {f.name: np.asarray(getattr(pj, f.name))
              for f in dataclasses.fields(pj)}
    return pj, convert.pair_from_numpy(fields, device="cpu",
                                       dtype=torch.float64)


@pytest.mark.parametrize("coul", [True, False], ids=["coul", "lj"])
def test_special_correction_sparse_matches_jax(coul):
    from lidp_tpu.box import Box as JBox
    from lidp_tpu.ops.bonded import special_correction_sparse as jcorr

    from lidp_tpu_torch import topology as ttopo
    from lidp_tpu_torch.box import Box as TBox
    from lidp_tpu_torch.ops.bonded import special_correction_sparse

    c = _special_case()
    si, sl = ttopo.special_lists(c["n"], c["bonds"])
    assert set(np.unique(sl)) == {0, 1, 2, 3}
    pj, pt = _tables(coul, (0.0, 0.5, 0.8333))
    bj = JBox.create(np.zeros(3), c["L"], dtype=jnp.float64)
    bt = TBox.create(np.zeros(3), c["L"], dtype=torch.float64)
    ref = jcorr(jnp.asarray(c["x"]), jnp.asarray(c["q"]),
                jnp.asarray(c["type"], jnp.int32), jnp.asarray(si),
                jnp.asarray(sl, jnp.int32), jnp.asarray(c["mask"]), bj, pj)
    got = special_correction_sparse(
        torch.as_tensor(c["x"]), torch.as_tensor(c["q"]),
        torch.as_tensor(c["type"]), torch.as_tensor(si).long(),
        torch.as_tensor(sl).long(), torch.as_tensor(c["mask"]), bt, pt)
    for k, g, r in zip(("f", "devdwl", "decoul", "virial"), got, ref):
        r = np.asarray(r, np.float64)
        np.testing.assert_allclose(
            g.numpy(), r, rtol=0, atol=1e-12 * max(np.abs(r).max(), 1e-300),
            err_msg=k)
    assert abs(float(got[1])) > 0
    assert (abs(float(got[2])) > 0) == coul


FF_CASES = ("ewald", "polar")


@pytest.mark.parametrize("name", FF_CASES)
def test_compute_forces_on_cells_matches_jax(name):
    """compute_forces on a 3 x 3 x 3 grid (cutoffs 4.0 / 4.5, coulomb 4.5,
    skin 0.5): the cell pair term, the special lists' correction
    (special_bonds 0.0 0.5 0.5), the Ewald sum and, in `polar`, the dense
    polar term (exponential damping, a warm start from a dipole guess)."""
    from lidp_tpu.box import Box as JBox
    from lidp_tpu.forcefield import ForceField as JFF
    from lidp_tpu.forcefield import compute_forces as jcompute
    from lidp_tpu.ops import ewald as jewald
    from lidp_tpu.ops import polarization as jpol
    from lidp_tpu.ops.cells import CellConfig as JCfg
    from lidp_tpu.ops.cells import build_cells as jbuild
    from lidp_tpu.state import make_system

    from lidp_tpu_torch import convert
    from lidp_tpu_torch import topology as ttopo
    from lidp_tpu_torch.forcefield import compute_forces, pair_route
    from lidp_tpu_torch.ops.cells import CellConfig, build_cells

    c = _special_case(seed=7, nmol=48, L=(15.0, 16.0, 17.0))
    n, L = c["n"], c["L"]
    x = c["x"] - np.floor(c["x"] / L) * L
    rng = np.random.RandomState(9)
    alpha = np.where(c["type"] == 1, 1.1, 0.4)
    mu = rng.normal(0, 0.03, (n, 3))
    mol = np.repeat(np.arange(1, n // 4 + 1), 4)
    es = jewald.setup_ewald_disp(accuracy_rel=1e-5, qqrd2e=332.06371,
                                 q=c["q"], natoms=n, cutoff=4.5,
                                 box_lengths=L)
    pj, _ = _tables(True, (0.0, 0.5, 0.5), g_ewald=es.g_ewald)
    ew = jewald.EwaldParams.from_setup(es, 332.06371, dtype=jnp.float64)
    pol = None
    if name == "polar":
        pol = jpol.PolarizationSettings(
            iterations_max=50, damping_type=jpol.DAMPING_EXPONENTIAL,
            polar_damp=2.1304, polar_precision=1e-11, use_previous=True)
    si, sl = ttopo.special_lists(n, c["bonds"])
    ffj = JFF(pair=pj, ewald=ew, polar=pol, qqrd2e=332.06371,
              sp_idx=jnp.asarray(si), sp_lvl=jnp.asarray(sl, jnp.int32))
    box = JBox.create(np.zeros(3), L, dtype=jnp.float64)
    sysj = make_system(x, box=box, v=np.zeros((n, 3)), q=c["q"],
                       type=c["type"], mol=mol, alpha=alpha,
                       mask=c["mask"], dtype=jnp.float64)
    sysj = sysj.replace(mu=jnp.asarray(mu))
    cfg = JCfg.for_box(L, 5.0, density=n / float(np.prod(L)),
                       cap_slack=4.0)
    assert cfg.nbins == (3, 3, 3)
    cj = jbuild(sysj.x, sysj.mask, sysj.box, cfg)
    rj = jcompute(sysj, ffj, cj)

    fft = convert.forcefield_from_numpy(
        {f.name: np.asarray(getattr(pj, f.name))
         for f in dataclasses.fields(pj)},
        {f.name: np.asarray(getattr(ew, f.name))
         for f in dataclasses.fields(ew)},
        None if pol is None else dataclasses.asdict(pol), 332.06371,
        device="cpu", dtype=torch.float64, sp_idx=si, sp_lvl=sl)
    syst = convert.system_from_numpy(
        dict({k: np.asarray(getattr(sysj, k)) for k in
              ("x", "v", "q", "type", "mol", "alpha", "mu", "image",
               "mask")}, box=dict(lo=np.zeros(3), hi=L)), device="cpu")
    ct = build_cells(syst.x, syst.mask, syst.box,
                     CellConfig(cfg.nbins, cfg.cap, cfg.cutneigh))
    assert not bool(ct.overflow) and not bool(cj.overflow)
    np.testing.assert_array_equal(ct.atom_of_slot.numpy(),
                                  np.asarray(cj.atom_of_slot))
    assert pair_route(syst, fft, ct) == "cell_pair_forces"
    rt = compute_forces(syst, fft, ct)
    for k in ("f", "virial", "mu"):
        r = np.asarray(getattr(rj, k), np.float64)
        np.testing.assert_allclose(getattr(rt, k).numpy(), r, rtol=0,
                                   atol=1e-8 * np.abs(r).max(), err_msg=k)
    ks = ("evdwl", "ecoul", "elong", "epol")
    scale = max(abs(float(getattr(rj, k))) for k in ks)
    for k in ks:
        assert abs(float(getattr(rt, k)) - float(getattr(rj, k))) \
            <= 1e-8 * scale, k
    assert int(rt.scf_iters) == int(rj.scf_iters)
    assert (int(rt.scf_iters) > 0) == (name == "polar")


# ------------------------- the point-charge fluid -----------------------

@pytest.fixture(scope="module")
def fluid_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("point_charge")
    chip_smoke.fluid_script_case(str(d), n_side=5)
    return d


PC_CASES = {"dense": None, "cells": 300}


@pytest.mark.parametrize("name", list(PC_CASES))
def test_point_charge_fluid_rows_match_jax(fluid_dir, name):
    text = chip_smoke.point_charge_script().replace(
        "read_data fluid.data\n", "read_data fluid.data\nneighbor 0.1 bin\n")
    js, ts = _both(text, fluid_dir, variables={"nstep": "3"},
                   cap=PC_CASES[name])
    cfg = ts._sim.runner.neighbor_cfg
    assert _cfg(cfg) == _cfg(js._sim.runner.neighbor_cfg)
    assert ts._sim.runner.ff.polar is None and ts._sim.runner.ff.ewald
    cancel = {}
    if name == "cells":
        assert cfg.nbins == (3, 3, 3)
        assert ts._sim.runner.ff.sp_idx is not None
        assert ts._sim.runner.ff.sp_code is None
        cancel = chip_smoke.cancelled(ts._sim)
        assert cancel["evdwl"] > 1e8
    else:
        assert cfg is None and ts._sim.runner.ff.sp_code is not None
    assert len(ts.thermo_rows) == 4
    _rows_close(ts, js, chip_smoke.G64_COLS, ROWS, cancel)
    _state_close(ts, js)


# ------------------------------ dump atom -------------------------------

def test_melt_dump_atom_matches_jax(tmp_path):
    texts = []
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        _run(pkg, melt_text(), d)
        texts.append((d / "dump.melt").read_text())
    assert texts[0] == texts[1]
    assert texts[1].count("ITEM: TIMESTEP") == 3
    assert "ITEM: ATOMS id type xs ys zs" in texts[1]


# --------------------------------- CLIs ---------------------------------

def _cli_cases():
    return {"in.lj": (chip_smoke.LJ_SCRIPT,
                      ["-var", "x", "0.25", "-var", "y", "0.25", "-var",
                       "z", "0.25"]),
            "in.melt": (chip_smoke.MELT_SCRIPT.replace(
                "block 0 10 0 10 0 10", "block 0 5 0 5 0 5"), []),
            "in.fluid": (chip_smoke.point_charge_script(),
                         ["-var", "nstep", "3"])}


@pytest.mark.parametrize("name", ["in.lj", "in.melt", "in.fluid"])
def test_clis_agree(fluid_dir, tmp_path, name):
    """The port's CLI on the input as a user runs it, logged at 16 digits,
    against the JAX package's script engine on the same input (what
    `python -m lidp_tpu` runs) in this process."""
    text, args = _cli_cases()[name]
    text = text.replace("run", "thermo_modify format float %.16g\nrun", 1)
    d = fluid_dir if name == "in.fluid" else tmp_path
    (d / f"{name}.16").write_text(text)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, (
                   str(ROOT), os.environ.get("PYTHONPATH")))))
    for k in ("LIDP_FAST_POLAR", "LIDP_FAST_POLAR_MODE"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-m", "lidp_tpu_torch", "-in", f"{name}.16",
         "-log", str(tmp_path / "log.torch"), *args, "-device", "cpu"],
        cwd=d, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    tr = chip_smoke.log_rows(
        (tmp_path / "log.torch").read_text().splitlines())
    jd = d
    if d == tmp_path:
        # its own directory: in.melt writes dump.melt
        jd = tmp_path / "jax"
        jd.mkdir()
    jr = _run("jax", text, jd, variables=dict(zip(args[1::3], args[2::3])))[
        0].thermo_rows
    assert len(jr) == len(tr) > 1
    cols = [c for c in tr[0] if c != "step"]
    chip_smoke.rows_agree(name, tr, jr, [ROWS] * len(jr), cols=cols)


# ---------------------------- what still raises -------------------------

UNPORTED = {
    # region sphere is ported: a moving region still raises
    "region sphere": ("region s sphere 0 0 0 1 move v_x NULL NULL",
                      "queue 1 item 6"),
    "create_atoms random": ("create_atoms 1 random 10 4 NULL",
                            "queue 1 item 6"),
    # lj/cut/coul/cut, the item-6.6 styles and pair gran/* (item 6.11)
    # are ported: the newer pair_style granular still raises
    "lj/cut/coul/cut": ("pair_style granular hooke 2000.0 50.0 tangential "
                        "linear_history 571.4 0.5 0.5", "queue 1 item 6"),
    "lattice diamond": ("lattice diamond 1.0", "queue 1 item 6"),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_atomic_commands_raise(tmp_path, name):
    line, item = UNPORTED[name]
    text = ("units lj\natom_style atomic\nlattice fcc 0.8442\n"
            "region box block 0 3 0 3 0 3\ncreate_box 1 box\n" + line + "\n")
    with pytest.raises(NotImplementedError, match=item):
        _run("torch", text, tmp_path)


def test_a_small_box_above_the_cap_raises(tmp_path):
    """in.lj's 500 atoms above a cap mocked to 300: 5 lattice cells a side
    are under 3 bins of 2.8, where the JAX package takes a neighbour list,
    which the port lacks (queue 1 item 5)."""
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        _run("torch", lj_text(), tmp_path, variables=lj_side(5), cap=300)


def test_a_cell_overflow_aborts_the_run(tmp_path):
    """A grid that overfills aborts at the end of the chunk with the JAX
    package's message: in.lj at 11 cells a side with its capacity slack
    forced down."""
    from lidp_tpu_torch import sim as tsim
    from lidp_tpu_torch.ops.cells import CellConfig

    real = CellConfig.for_box

    def tight(L, cutneigh, density, cap_slack=2.0, perp=None):
        return real(L, cutneigh, density, cap_slack=0.3, perp=perp)

    with mock.patch.object(tsim.CellConfig, "for_box", staticmethod(tight)), \
            pytest.raises(RuntimeError, match="cell capacity overflow"):
        _run("torch", lj_text(nrun=5, every=5), tmp_path,
             variables=lj_side(11))
