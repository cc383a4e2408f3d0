"""The port's first float64 evaluation in a fresh process does not depend
on the number of CPU threads torch runs it on.

Each case runs its evaluation as the first of fresh `python -c` processes
with torch's default thread count (REPEATS of them, PARALLEL at a time, so
that the threads of several processes share the cores, as under
pytest-xdist) and once with OMP_NUM_THREADS=1 and torch.set_num_threads(1);
every array the threaded runs save agrees with the one-thread run's to rel
1e-12 of its largest entry.  That bar lies far below the 2.5e-8 and 1.7e-7
that the port's tests once recorded for a first evaluation on several
threads, and far above what a threaded reduction's other summation order
changes.  The subprocesses import torch and the port, never JAX:

  * panel_step: PolarStep's first float64 evaluation (the panel engine's
    plain path, LIDP_FAST_POLAR=1) on the 375-atom fluid of
    chip_smoke.fluid_script_case(n_side=5) through
    LammpsScript(dtype=torch.float64, device="cpu"), step 0 only: forces,
    dipoles and the thermo row's energies;
  * pair_plain: the plain row form of tests/test_torch_pair_symmetric.py's
    first float64 case (ops/panel.pair_wolf_panel_plain on its _case());
  * dense_route: the same script as panel_step without LIDP_FAST_POLAR,
    the dense route's first evaluation;
  * cell_route: bench/in.lj (chip_smoke.LJ_SCRIPT) cut to 6 lattice cells
    a side (864 atoms) above a dense cap set to 300, so on the cell grid
    (3 x 3 x 3: its plain pair pass, no special bonds, no Ewald, no polar
    term), `run 1`: the rows of steps 0 and 1 and the forces of step 1 (on
    the lattice of step 0 they cancel to rounding, which another summation
    order changes);
  * dense_npt_pppm: panel_step's fluid with `fix rigid/npt` and
    `kspace_style pppm 1e-4` (the mesh's spread, FFTs and gather, the
    rigid barostat's remaps) on the dense route, `run 1`: the rows of
    steps 0 and 1, step 1's forces and dipoles and its box.

The fault these processes look for is not located (ROADMAP queue 3 item
1): in about 410 such processes it showed once, in one of about 270 of
panel_step, and the parity files that once recorded it passed without
their one-thread pin in two runs under pytest-xdist.  Until an operation
is found and repaired the parity files keep the pin (test_torch_script.py,
test_torch_pair_symmetric.py, test_torch_dense_route.py and
test_torch_thermostats.py, whose script cases load the dense route of
dense_route here) and this test is marked xfail, not strict: it runs in
every suite and reports XPASS or XFAIL.

A failing comparison keeps its evidence: the one-thread run's and the
failing process's .npz are copied to a directory of their own in the
system's temporary directory (tempfile.mkdtemp, which pytest's cleanup of
its tmp_path does not remove), and the assertion names that directory,
the case, the process, the array and the first index that differs.
"""

import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke

ROOT = Path(__file__).resolve().parent.parent
REPEATS = 12
PARALLEL = 6
REL = 1e-12

_PRELUDE = """\
import os, sys
import numpy as np
import torch
if os.environ.get("ONE_THREAD"):
    torch.set_num_threads(1)
out = sys.argv[1]
"""

_SCRIPT = _PRELUDE + """\
from lidp_tpu_torch.io.script import LammpsScript
s = LammpsScript(dtype=torch.float64, device="cpu", log=lambda line: None)
s.variables["nstep"] = "0"
s.file(sys.argv[2])
sim = s._sim
n = sim.natoms
row = s.thermo_rows[0]
np.savez(out, f=sim.res.f[:n].numpy(), mu=sim.sys.mu[:n].numpy(),
         row=np.array([row[c] for c in ("pe", "evdwl", "ecoul", "elong",
                                        "epol", "press")]))
assert "jax" not in sys.modules
"""

_LJ = _PRELUDE + """\
from lidp_tpu_torch.io.script import LammpsScript
from lidp_tpu_torch.parallel import fast_polar
fast_polar.DENSE_PATH_MAX_ATOMS = 300
s = LammpsScript(dtype=torch.float64, device="cpu", log=lambda line: None)
s.variables.update(x="0.3", y="0.3", z="0.3")
s.file(sys.argv[2])
sim = s._sim
assert sim.runner.neighbor_cfg.nbins == (3, 3, 3) and sim.natoms == 864
np.savez(out, f=sim.res.f.numpy(),
         rows=np.array([[r[c] for c in ("pe", "ke", "press")]
                        for r in s.thermo_rows]))
assert "jax" not in sys.modules
"""

_NPT = _PRELUDE + """\
from lidp_tpu_torch.io.script import LammpsScript
s = LammpsScript(dtype=torch.float64, device="cpu", log=lambda line: None)
s.variables["nstep"] = "1"
s.file(sys.argv[2])
sim = s._sim
n = sim.natoms
assert sim.runner.neighbor_cfg is None and sim.runner.ff.pppm is not None
np.savez(out, f=sim.res.f[:n].numpy(), mu=sim.sys.mu[:n].numpy(),
         box=sim.sys.box.hi.numpy(),
         rows=np.array([[r[c] for c in ("pe", "evdwl", "ecoul", "elong",
                                        "epol", "press", "vol")]
                        for r in s.thermo_rows]))
assert "jax" not in sys.modules
"""

_PAIR = _PRELUDE + """\
from lidp_tpu_torch.ops import panel
c = np.load(sys.argv[2])
t = lambda k: torch.as_tensor(c[k])
f, ev, ec, vir, e0 = panel.pair_wolf_panel_plain(
    t("x"), t("q"), t("type"), t("mol"), t("mask"), t("tabs"), t("L"),
    float(c["cut_coulsq"]), float(c["qqrd2e"]), float(c["g_ewald"]),
    sp=torch.as_tensor(c["sp"]))
np.savez(out, f=f.numpy(), e0=e0.numpy(),
         scalars=torch.cat([ev[None], ec[None], vir]).numpy())
assert "jax" not in sys.modules
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The fluid's data file and input, and the pair case's arrays."""
    from tests.test_torch_pair_symmetric import (CUT_COULSQ, G_EWALD,
                                                 QQRD2E, _case)

    d = tmp_path_factory.mktemp("threads")
    _, in_fluid = chip_smoke.fluid_script_case(str(d), n_side=5)
    c = _case()
    np.savez(d / "pair_case.npz", cut_coulsq=CUT_COULSQ, qqrd2e=QQRD2E,
             g_ewald=G_EWALD,
             **{k: c[k] for k in ("x", "q", "type", "mol", "mask", "tabs",
                                  "L", "sp")})
    (d / "in.lj").write_text(
        chip_smoke.LJ_SCRIPT.replace("run\t\t100", "run 1"))
    (d / "in.npt").write_text(chip_smoke.FLUID_SCRIPT.replace(
        "fix 1 all rigid/nve molecule",
        "fix 1 all rigid/npt molecule temp 300 300 100 iso 1 1 1000").replace(
        "kspace_style ewald/disp 1e-4", "kspace_style pppm 1e-4"))
    return {"panel_step": (_SCRIPT, in_fluid, {"LIDP_FAST_POLAR": "1"}),
            "pair_plain": (_PAIR, str(d / "pair_case.npz"), {}),
            "dense_route": (_SCRIPT, in_fluid, {}),
            "cell_route": (_LJ, str(d / "in.lj"), {}),
            "dense_npt_pppm": (_NPT, str(d / "in.npt"), {})}


def _run(code, arg, env_extra, out, one_thread):
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                        "LIDP_FAST_POLAR")}
    env.update(env_extra, PYTHONPATH=os.pathsep.join(filter(None, (
        str(ROOT), os.environ.get("PYTHONPATH")))))
    if one_thread:
        env.update(OMP_NUM_THREADS="1", ONE_THREAD="1")
    res = subprocess.run([sys.executable, "-c", code, str(out), arg],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.xfail(strict=False, reason=(
    "the float64 first-evaluation fault on several CPU threads is not "
    "located (ROADMAP queue 3 item 1): seen once in ~270 processes"))
@pytest.mark.parametrize("case", ["panel_step", "pair_plain",
                                  "dense_route", "cell_route",
                                  "dense_npt_pppm"])
def test_first_float64_evaluation_is_thread_independent(inputs, case,
                                                        tmp_path):
    code, arg, env = inputs[case]
    ref = _run(code, arg, env, tmp_path / "one.npz", one_thread=True)
    with ThreadPoolExecutor(PARALLEL) as pool:
        runs = list(pool.map(
            lambda k: _run(code, arg, env, tmp_path / f"run{k}.npz",
                           one_thread=False), range(REPEATS)))
    worst = {}
    for k, got in enumerate(runs):
        assert got.keys() == ref.keys()
        for name, r in ref.items():
            diff = np.abs(got[name] - r)
            bar = REL * np.abs(r).max()
            err = float(diff.max() / np.abs(r).max())
            worst[name] = max(worst.get(name, 0.0), err)
            if not err <= REL:
                raise AssertionError(_keep_evidence(
                    case, k, name, err, got[name], r, diff, bar, tmp_path))
    assert all(np.isfinite(v).all() for v in ref.values()), worst


def _keep_evidence(case, k, name, err, got, ref, diff, bar, tmp_path):
    """Copy the one-thread and the failing run's arrays out of pytest's
    tmp_path; the assertion message that names them."""
    keep = tempfile.mkdtemp(prefix=f"lidp_threads_{case}_run{k}_")
    for f in ("one.npz", f"run{k}.npz"):
        shutil.copy(tmp_path / f, keep)
    idx = tuple(int(i) for i in np.argwhere(~(diff <= bar))[0])
    return (f"case {case}, process {k} (run{k}.npz), array {name}: max "
            f"rel err {err:.3e} above {REL:g}; first differing index {idx}: "
            f"{got[idx]!r} against the one-thread run's {ref[idx]!r}; "
            f"arrays kept in {keep}")


def test_a_failure_keeps_its_evidence(tmp_path):
    """_keep_evidence copies both runs' arrays out of tmp_path and names
    the directory, case, process, array and first differing index."""
    ref = np.arange(12.0).reshape(4, 3) + 1.0
    got = ref.copy()
    got[2, 1] += 1e-6
    got[3, 0] = np.nan
    np.savez(tmp_path / "one.npz", f=ref)
    np.savez(tmp_path / "run5.npz", f=got)
    diff = np.abs(got - ref)
    msg = _keep_evidence("dense_route", 5, "f", float(np.nanmax(diff)),
                         got, ref, diff, REL * np.abs(ref).max(), tmp_path)
    keep = msg.rsplit("arrays kept in ", 1)[1]
    try:
        assert "case dense_route, process 5 (run5.npz), array f" in msg
        assert "first differing index (2, 1)" in msg
        assert sorted(os.listdir(keep)) == ["one.npz", "run5.npz"]
        np.testing.assert_array_equal(np.load(f"{keep}/run5.npz")["f"], got)
    finally:
        shutil.rmtree(keep)
