"""Flexible molecules from a LAMMPS script: examples/peptide's and
bench/in.rhodo's stack (lj/charmm/coul/long, the bonded styles, special_bonds
charmm, pppm, fix nvt / fix npt with fix shake) through the port against the
JAX package, float64 on the CPU, on chip_smoke.flexible_script_case at 192
atoms (n_side (2, 2, 2), cutoffs 4.0 / 5.5 inside the 12.6 A box):

  * both CLIs (`-device cpu` on the port) on the dense route, fix nvt and
    fix shake, 5 steps logged at 16 digits: every column of thermo_style
    multi at rel 1e-8 of max(1, |value|), and E_mol (PotEng less E_vdwl,
    E_coul and E_long) the sum of E_bond, E_angle, E_dihed and E_impro;
  * the case replicated 1 x 1 x 3 (576 atoms) above a dense cap mocked to
    300 in both packages, on the cell grid, with fix npt (in.rhodo's `iso
    ... mtk no pchain 0 tchain 1`) and fix shake, through both
    LammpsScripts: the same columns and the box at rel 1e-8, plus
    chip_smoke.CANCEL_REL of the magnitude the special correction cancels;
  * lj/charmm/coul/charmm without k-space (in.rhodo's variant without
    pppm), dense route: the same;
  * what the port leaves out raises NotImplementedError naming itself and
    its ROADMAP item: lj/charmm/coul/msm with this script's pppm (it runs
    with kspace_style msm, tests/test_torch_msm.py), a composition left to
    item 6.5; the rest of the CHARMM family (coul/charmm/implicit, the
    charmmfsw styles with dihedral_style charmmfsw) on the cell grid with
    special bonds, where the JAX package's special correction parts from
    its dense route (queue 3 item 38); fix cmap's crossterms through
    replicate (queue 3 item 39); pair hbond/dreiding with neigh_modify
    exclude (queue 3 item 40); and bonded terms with the polar style on
    the panel engine (LIDP_FAST_POLAR=1).  These styles' rows against the
    JAX package's are in tests/test_torch_charmm_family.py,
    test_torch_cmap.py and test_torch_hbond.py.
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
NSTEP = 5
SIDE = (2, 2, 2)
CUT = (4.0, 5.5)
MULTI = ("etotal", "ke", "temp", "pe", "ebond", "eangle", "edihed", "eimp",
         "evdwl", "ecoul", "elong", "press")
BOX_COLS = ("vol", "lx", "ly", "lz", "xlo", "xhi", "zlo", "zhi")
PARTS = ("ebond", "eangle", "edihed", "eimp")


@pytest.fixture(scope="module")
def flex(tmp_path_factory):
    d = tmp_path_factory.mktemp("flex")
    chip_smoke.flexible_script_case(str(d), n_side=SIDE, cut=CUT)
    return d


def _env(extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("LIDP_FAST_POLAR", "LIDP_FAST_POLAR_MODE")}
    env.update(extra or {})
    return env


def _run(pkg, d, text, cap=None, env=None, nstep=NSTEP):
    """`text` through pkg's LammpsScript in directory d (float64; the port
    on the CPU), DENSE_PATH_MAX_ATOMS mocked to `cap` in both packages
    where given."""
    path = d / f"in.{pkg}"
    path.write_text(text)
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    s.variables["nstep"] = str(nstep)
    cap = cap or jsim.DENSE_PATH_MAX_ATOMS
    with mock.patch.dict(os.environ, _env(env), clear=True), \
            mock.patch.object(jsim, "DENSE_PATH_MAX_ATOMS", cap), \
            mock.patch.object(tfast, "DENSE_PATH_MAX_ATOMS", cap):
        s.file(str(path))
    return s


def _emol_is_the_sum(rows):
    for r in rows:
        parts = sum(r[c] for c in PARTS)
        emol = r["emol"] if "emol" in r else (
            r["pe"] - r["evdwl"] - r["ecoul"] - r["elong"])
        assert abs(emol - parts) <= 1e-8 * max(1.0, abs(emol)), r


def test_clis_agree_on_the_dense_route(flex, tmp_path):
    """Both CLIs, fix nvt + fix shake + pppm, 5 steps."""
    text = chip_smoke.flexible_script(cut=CUT).replace(
        "run ${nstep}", "thermo_modify format float %.16g\nrun ${nstep}")
    (flex / "in.cli").write_text(text)
    env = _env(dict(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                    PYTHONPATH=os.pathsep.join(filter(None, (
                        str(ROOT), os.environ.get("PYTHONPATH"))))))
    rows = {}
    for pkg, extra in (("lidp_tpu", []),
                       ("lidp_tpu_torch", ["-device", "cpu"])):
        log = tmp_path / f"log.{pkg}"
        res = subprocess.run(
            [sys.executable, "-m", pkg, "-in", "in.cli", "-var", "nstep",
             str(NSTEP), "-log", str(log), *extra], cwd=flex, env=env,
            capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        rows[pkg] = chip_smoke.log_rows(log.read_text().splitlines())
    assert len(rows["lidp_tpu"]) == NSTEP + 1
    assert set(MULTI) <= set(rows["lidp_tpu_torch"][0])
    chip_smoke.rows_agree("cli", rows["lidp_tpu_torch"], rows["lidp_tpu"],
                          [1e-8] * (NSTEP + 1), cols=MULTI)
    _emol_is_the_sum(rows["lidp_tpu_torch"])
    # the bonded terms and the 1-4 term act
    r = rows["lidp_tpu_torch"][-1]
    assert all(r[c] != 0.0 for c in PARTS)


CASES = {
    "cells_npt_shake": (chip_smoke.flexible_script(
        chip_smoke.FLEX_NPT, cut=CUT, replicate=(1, 1, 3)), 300),
    "coul_charmm": (chip_smoke.flexible_script(
        cut=CUT, pair=f"lj/charmm/coul/charmm {CUT[0]} {CUT[1]}",
        kspace=None), None),
}


@pytest.fixture(scope="module")
def runs(flex):
    return {case: tuple(_run(pkg, flex, text, cap=cap)
                        for pkg in ("jax", "torch"))
            for case, (text, cap) in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_script_matches_jax(runs, case):
    js, ts = runs[case]
    sim = ts._sim
    cells = CASES[case][1] is not None
    assert (sim.runner.neighbor_cfg is not None) == cells
    assert (js._sim.runner.neighbor_cfg is not None) == cells
    assert sim.runner.every_step_ev and sim.runner.post_force is not None
    ff = sim.runner.ff
    assert ff.pair.charmm and len(ff.bond) == len(ff.angle) == 1
    assert ff.pair.coul_kind == ("charmm" if case == "coul_charmm"
                                 else "long")
    assert (ff.pppm is None) == (case == "coul_charmm")
    # the constrained X-H and water bonds and the water angle leave the
    # bonded terms: 4 of a solute's 11 bonds stay, its 18 angles stay, the
    # waters' go
    nmol = sim.natoms // 24
    assert ff.bond[0].idx.shape[0] == 4 * nmol
    assert ff.angle[0].idx.shape[0] == 18 * nmol
    cols = MULTI + ("emol", "epair") + (BOX_COLS if cells else ())
    assert len(ts.thermo_rows) == len(js.thermo_rows) == NSTEP + 1
    chip_smoke.rows_agree(case, ts.thermo_rows, js.thermo_rows,
                          [1e-8] * (NSTEP + 1), cols=cols,
                          cancel=chip_smoke.cancelled(sim) if cells else None)
    _emol_is_the_sum(ts.thermo_rows)
    n = sim.natoms
    for k in ("x", "v"):
        a = getattr(sim.sys, k)[:n].numpy()
        b = np.asarray(getattr(js._sim.sys, k))[:n]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 * np.abs(b).max(),
                                   err_msg=f"{case} {k}")
    if cells:
        vols = [r["vol"] for r in ts.thermo_rows]
        assert len(set(vols)) == len(vols)


# -------------------------------- refusals --------------------------------

def _cells(text):
    """text replicated 1 x 1 x 3 (576 atoms): the cell grid above a dense
    cap of 300."""
    return text.replace("read_data flex.data\n",
                        "read_data flex.data\nreplicate 1 1 3\n")


PAIR = f"pair_style lj/charmm/coul/long {CUT[0]:g} {CUT[1]:g}"
NO_KSPACE = ("kspace_style pppm 1e-4\n", "")
# name -> (edits of the script, the dense cap (the cell grid of the script
# replicated 1 x 1 x 3 where given), what the message names); the CHARMM
# family's styles now run on the dense route and raise on the cell grid
# with special bonds, fix cmap raises through replicate, hbond with an
# exclusion
ITEM_38 = "ROADMAP queue 3 item 38"
UNPORTED = {
    "coul/charmm/implicit": (
        [(PAIR, "pair_style lj/charmm/coul/charmm/implicit 4.0 5.5"),
         NO_KSPACE], 300, ITEM_38),
    "coul/msm": ([(PAIR, "pair_style lj/charmm/coul/msm 4.0 5.5")], None,
                 "ROADMAP queue 1 item 6"),
    "charmmfsw/coul/long": (
        [(PAIR, "pair_style lj/charmmfsw/coul/long 4.0 5.5")], 300, ITEM_38),
    "charmmfsw/coul/charmmfsh": (
        [(PAIR, "pair_style lj/charmmfsw/coul/charmmfsh 4.0 5.5"),
         NO_KSPACE], 300, ITEM_38),
    "dihedral charmmfsw": (
        [(PAIR, "pair_style lj/charmmfsw/coul/long 4.0 5.5"),
         ("dihedral_style charmm\n", "dihedral_style charmmfsw\n")], 300,
        ITEM_38),
    "fix cmap": ([("read_data flex.data\n",
                   f"fix 3 all cmap {chip_smoke.CMAP_FILE}\nread_data "
                   "flex.cmap fix 3 crossterm CMAP\nreplicate 1 1 3\n")],
                 None, "ROADMAP queue 3 item 39"),
    "hbond/dreiding": (
        [(PAIR, "pair_style hybrid/overlay lj/cut/coul/long 5.5 "
                "hbond/dreiding/lj 4 6 6.5 90"),
         ("pair_coeff 5 5 0.2 3.296 0.2 2.76\n",
          "pair_coeff * * lj/cut/coul/long 0.1 3.0\n"
          "pair_coeff 5 7 hbond/dreiding/lj 6 i 4.0 2.75\n"
          "neigh_modify exclude type 1 1\n")], None,
        "ROADMAP queue 3 item 40"),
}


@pytest.fixture(scope="module")
def flex_cmap(flex):
    """The flexible case's data with one crossterm per solute (flex.cmap,
    beside flex.data) and the seeded map file."""
    (flex / "cmap").mkdir(exist_ok=True)
    chip_smoke.flexible_script_case(str(flex / "cmap"), n_side=SIDE,
                                    cut=CUT, cmap="yes")
    (flex / "flex.cmap").write_text((flex / "cmap" / "flex.data")
                                    .read_text())
    (flex / chip_smoke.CMAP_FILE).write_text(
        (flex / "cmap" / chip_smoke.CMAP_FILE).read_text())
    return flex


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_styles_raise(flex_cmap, name):
    edits, cap, item = UNPORTED[name]
    text = chip_smoke.flexible_script(cut=CUT)
    for old, new in edits:
        assert old in text
        text = text.replace(old, new)
    if cap is not None:
        text = _cells(text)
    with pytest.raises(NotImplementedError, match=item):
        _run("torch", flex_cmap, text, cap=cap, nstep=1)


def test_bonded_terms_on_the_panel_engine_raise(tmp_path):
    """The polar fluid with bond_style zero under LIDP_FAST_POLAR=1: the
    prescan takes it, the panel engine declines the bonded term, and the
    port raises where the JAX package runs its Runner on the padded
    System."""
    chip_smoke.fluid_script_case(str(tmp_path), n_side=3)
    text = chip_smoke.FLUID_SCRIPT.replace(
        "read_data fluid.data\n",
        "bond_style zero\nread_data fluid.data\nbond_coeff *\n")
    with pytest.raises(NotImplementedError,
                       match="bonded terms.*ROADMAP queue 1 item 6"):
        _run("torch", tmp_path, text, env={"LIDP_FAST_POLAR": "1"}, nstep=1)
