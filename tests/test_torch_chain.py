"""bench/in.chain through the port's front end (atom_style bond,
special_bonds fene, bond_style fene, pair_style lj/cut with pair_modify
shift, fix nve and fix langevin on threefry.py's stream) against the JAX
package's, float64 on the CPU, both sides in one process:

  * chip_smoke.CHAIN_SCRIPT on chip_smoke.chain_script_case cut to 8
    chains of 25 beads (200 atoms, the dense route with its special codes)
    and to 40 chains of 25 (1,000 atoms) above a dense cap mocked to 300
    (the cell grid, 6 x 6 x 6, with the special lists' sparse correction),
    `thermo 1`, `run 5`: every row within rel 1e-8 of max(1, |value|)
    (plus chip_smoke.CANCEL_REL of what the correction cancels on the
    cell grid), the final x and v within 1e-8 of their largest entry;
    the retally rule: langevin runs the Runner with every_step_ev;
  * in float32 the cell case's pair route stays the plain cell pass (the
    special lists keep the LJ kernel off, as JAX's _pallas_ok does) and
    step 0 agrees with JAX's float64 row at rel 1e-5;
  * the System Simulation.from_script builds: zero charges, the data
    file's molecule IDs, bonds and no angles;
  * read_data of atom_style bond, angle and molecular (the chain with an
    Angles section) against JAX's arrays, and write_data's text against
    JAX's but for the title line;
  * the port's CLI on the 200-atom input, logged at 16 digits, against
    the JAX package's script engine on it: the same rows.
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
# one torch thread, for time, as the port's other parity files: under
# pytest-xdist torch's threads spin on the cores the other workers use
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu import sim as jsim  # noqa: E402
from lidp_tpu.io import data_reader as jreader  # noqa: E402
from lidp_tpu.io import data_writer as jwriter  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch.forcefield import pair_route  # noqa: E402
from lidp_tpu_torch.io import data_reader as treader  # noqa: E402
from lidp_tpu_torch.io import data_writer as twriter  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.parallel import fast_polar as tfast  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
COLS = ("temp", "epair", "emol", "etotal", "press")
ROWS = 1e-8
STATE = 1e-8
NSTEP = 5
# chains x beads and the dense cap of each case
CASES = {"dense": ((8, 25), None), "cells": ((40, 25), 300)}


def chain_text(nstep=NSTEP):
    return chip_smoke.CHAIN_SCRIPT.replace(
        "thermo          100", "thermo 1").replace("run\t\t100",
                                                   f"run\t\t{nstep}")


def _run(pkg, directory, text, cap=None, dtype64=True):
    """`text` through pkg's LammpsScript in `directory` (the port on the
    CPU), DENSE_PATH_MAX_ATOMS mocked to `cap` in both packages where
    given."""
    path = Path(directory) / f"in.{pkg}"
    path.write_text(text)
    log = lambda line: None  # noqa: E731
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64, log=log)
    else:
        s = tscript.LammpsScript(
            dtype=torch.float64 if dtype64 else torch.float32, device="cpu",
            log=log)
    cap = cap or jsim.DENSE_PATH_MAX_ATOMS
    with mock.patch.object(jsim, "DENSE_PATH_MAX_ATOMS", cap), \
            mock.patch.object(tfast, "DENSE_PATH_MAX_ATOMS", cap):
        s.file(str(path))
    return s


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Each case's directory and its JAX and port runs."""
    out = {}
    for name, ((nc, nb), cap) in CASES.items():
        d = tmp_path_factory.mktemp(f"chain_{name}")
        chip_smoke.chain_script_case(str(d), n_chains=nc, n_beads=nb)
        out[name] = (d, _run("jax", d, chain_text(), cap),
                     _run("torch", d, chain_text(), cap))
    return out


def _cancel(sim):
    cancel = dict(chip_smoke.cancelled(sim))
    if cancel:
        cancel["epair"] = cancel["evdwl"] + cancel["ecoul"]
    return cancel


@pytest.mark.parametrize("name", list(CASES))
def test_chain_rows_match_jax(chains, name):
    _, js, ts = chains[name]
    sim = ts._sim
    assert len(ts.thermo_rows) == len(js.thermo_rows) == NSTEP + 1
    cancel = _cancel(sim) if name == "cells" else {}
    chip_smoke.rows_agree(name, ts.thermo_rows, js.thermo_rows,
                          [ROWS] * (NSTEP + 1), cols=COLS, cancel=cancel)
    n = sim.natoms
    for k in ("x", "v"):
        a = getattr(sim.sys, k)[:n].numpy()
        b = np.asarray(getattr(js._sim.sys, k))[:n]
        np.testing.assert_allclose(a, b, rtol=0, atol=STATE * np.abs(b).max(),
                                   err_msg=k)
    # fix langevin is velocity-dependent: no chunk-boundary re-tally
    assert sim.runner.every_step_ev
    assert js._sim.runner.every_step_ev


def test_chain_routes(chains):
    _, js, ts = chains["dense"]
    assert ts._sim.runner.neighbor_cfg is None
    assert ts._sim.runner.ff.sp_code is not None
    _, js, ts = chains["cells"]
    cfg = ts._sim.runner.neighbor_cfg
    assert cfg.nbins == (6, 6, 6) == js._sim.runner.neighbor_cfg.nbins
    assert ts._sim.runner.ff.sp_idx is not None
    assert pair_route(ts._sim.sys, ts._sim.runner.ff, ts._sim.nlist.nlist) \
        == "cell_pair_forces"
    assert _cancel(ts._sim)["evdwl"] > 0.0


def test_chain_float32_takes_the_plain_cell_pass(chains):
    d, js, _ = chains["cells"]
    ts = _run("torch", d, chain_text(nstep=0), cap=300, dtype64=False)
    sim = ts._sim
    assert sim.sys.x.dtype == torch.float32
    assert pair_route(sim.sys, sim.runner.ff, sim.nlist.nlist) \
        == "cell_pair_forces"
    chip_smoke.rows_agree("f32", ts.thermo_rows, js.thermo_rows[:1], [1e-5],
                          cols=COLS)


def test_chain_system(chains):
    d, js, ts = chains["dense"]
    sim, data = ts._sim, ts.data
    n = sim.natoms
    assert n == 200 and len(ts._bonds) == 192
    assert torch.count_nonzero(sim.sys.q) == 0
    np.testing.assert_array_equal(sim.sys.mol.numpy(), data.mol)
    np.testing.assert_array_equal(sim.sys.mol.numpy(),
                                  np.repeat(np.arange(1, 9), 25))
    ff = sim.runner.ff
    assert len(ff.bond) == 1 and ff.bond[0].style == "fene"
    assert ff.angle == ff.dihedral == ff.improper == ()
    assert ts._angles is None or not len(ts._angles)


def _with_angles(src, dst):
    """The chain's data file with an Angles section: one angle for each
    three consecutive beads of a chain."""
    text = Path(src).read_text()
    d = treader.read_data(str(src), atom_style="bond")
    b = d.bonds
    # consecutive bonds of one chain share their middle atom
    share = b[:-1, 1] == b[1:, 0]
    angles = np.stack([b[:-1, 0], b[:-1, 1], b[1:, 1]], 1)[share]
    text = text.replace("1 bond types\n", f"1 bond types\n{len(angles)} "
                        "angles\n1 angle types\n")
    text += "\nAngles\n\n" + "".join(
        f"{k + 1} 1 {i} {j} {m}\n" for k, (i, j, m) in enumerate(angles))
    Path(dst).write_text(text)
    return len(angles)


@pytest.mark.parametrize("style", ["bond", "angle", "molecular"])
def test_read_and_write_data_match_jax(chains, tmp_path, style):
    d = chains["dense"][0]
    path = d / "data.chain"
    nangles = 0
    if style != "bond":
        nangles = _with_angles(path, tmp_path / "data.angles")
        path = tmp_path / "data.angles"
    a = treader.read_data(str(path), atom_style=style)
    b = jreader.read_data(str(path), atom_style=style)
    for k in ("x", "v", "q", "type", "mol", "image", "mass", "bonds",
              "bond_types", "angles", "angle_types", "box_lo", "box_hi"):
        va, vb = getattr(a, k), getattr(b, k)
        assert (va is None) == (vb is None), k
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=k)
            assert np.asarray(va).dtype == np.asarray(vb).dtype, k
    assert len(a.angles) == nangles and not np.any(a.q)
    texts = []
    for pkg, mod, writer in (("jax", jscript, jwriter),
                             ("torch", tscript, twriter)):
        s = (mod.LammpsScript(dtype=jnp.float64) if pkg == "jax"
             else mod.LammpsScript(dtype=torch.float64, device="cpu"))
        s.root = str(path.parent)
        s.one(f"atom_style {style}")
        s.one(f"read_data {path.name}")
        out = tmp_path / f"{pkg}.data"
        writer.write_data(str(out), s)
        texts.append(out.read_text().splitlines())
    assert texts[0][0] != texts[1][0] and texts[0][1:] == texts[1][1:]
    assert f"{nangles} angles" in texts[1] or not nangles


def test_cli_agrees(chains, tmp_path):
    """The port's CLI on the 200-atom chain as a user runs it (`-device
    cpu`), logged at 16 digits, against the JAX package's script engine on
    the same input (the dense case's run)."""
    d, js, _ = chains["dense"]
    text = chain_text().replace("run", "thermo_modify format float %.16g\nrun",
                                1)
    (d / "in.chain16").write_text(text)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        filter(None, (str(ROOT), os.environ.get("PYTHONPATH")))))
    log = tmp_path / "log.torch"
    res = subprocess.run(
        [sys.executable, "-m", "lidp_tpu_torch", "-in", "in.chain16", "-log",
         str(log), "-device", "cpu"], cwd=d, env=env, capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    rows = chip_smoke.log_rows(log.read_text().splitlines())
    chip_smoke.rows_agree("cli", rows, js.thermo_rows, [ROWS] * (NSTEP + 1),
                          cols=COLS)
