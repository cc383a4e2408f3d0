"""The port's first float64 evaluation in a fresh process does not depend
on the number of CPU threads torch runs it on.

Each case runs its evaluation as the first of fresh processes with
torch's default thread count (REPEATS of them, PARALLEL at a time, so
that the threads of several processes share the cores, as under
pytest-xdist) and once with OMP_NUM_THREADS=1 and torch.set_num_threads(1);
every array the threaded runs save agrees with the one-thread run's to rel
1e-12 of its largest entry.  That bar lies far below the 2.5e-8 and 1.7e-7
that the port's tests once recorded for a first evaluation on several
threads, and far above what a threaded reduction's other summation order
changes.  The processes are forked from zygotes (_ZYGOTE): processes
that import numpy and torch once and then compute nothing, so that each
child's first parallel region, first vector-math call and import of the
port (with its warm_vector_math) are its own, as in a fresh interpreter,
without the ~3 s of importing torch in each of the 78 processes.  The
one-thread runs fork from a zygote started with OMP_NUM_THREADS=1, the
others from PARALLEL zygotes on the default threads.  Every zygote runs
under OMP_WAIT_POLICY=PASSIVE: idle OpenMP threads sleep rather than spin,
so that PARALLEL processes of a core's count of threads each share the
cores without each parallel region's barrier waiting on spinning threads
(with the default policy one process's run of the cell_route case took
~15 s among them against 0.7 s alone; passive, 12 take 1.6 s in all).
Without warm_vector_math, 16 and 17 of 600 such children (default and
passive policy) computed their first float64 torch.sqrt with a chunk at
~1e-11, the rate recorded for fresh interpreters.  The children import
the port, never JAX:

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
    steps 0 and 1, step 1's forces and dipoles and its box;
  * flexible_shake: the flexible molecules of
    chip_smoke.flexible_script_case(n_side=(2, 2, 2), cut=(4.0, 5.5))
    (192 atoms: lj/charmm/coul/long, the bonded terms' index_add_
    scatters over the bond, angle, dihedral and improper lists, pppm, fix
    nvt and the SHAKE solve of fix shake) on the dense route, `run 1`: the
    rows of steps 0 and 1 (every energy of thermo_style multi), step 1's
    forces and positions.

The fault these processes look for is located (ROADMAP queue 3 item 1):
the first call of torch.sqrt on a float64 CPU tensor in a process with
several threads can return one thread's chunk at ~35-bit accuracy (MKL's
vector math; the calls after it are right), so the first evaluation's
pair term differed from the one-thread run's in one chunk of rows.
lidp_tpu_torch/__init__.py (warm_vector_math) now calls each such
function once on every thread when the package is imported; the test ran
clean in the suites after it, and a recurrence now fails it.

A failing comparison keeps its evidence: the one-thread run's and the
failing process's .npz are copied to a directory of their own in the
system's temporary directory (tempfile.mkdtemp, which pytest's cleanup of
its tmp_path does not remove), and the assertion names that directory,
the case, the process, the array and the first index that differs.
"""

import json
import os
import queue
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

_FLEX = _PRELUDE + """\
from lidp_tpu_torch.io.script import LammpsScript
s = LammpsScript(dtype=torch.float64, device="cpu", log=lambda line: None)
s.variables["nstep"] = "1"
s.file(sys.argv[2])
sim = s._sim
assert sim.runner.neighbor_cfg is None and sim.runner.post_force is not None
np.savez(out, f=sim.res.f.numpy(), x=sim.sys.x.numpy(),
         rows=np.array([[r[c] for c in ("pe", "evdwl", "ecoul", "elong",
                                        "ebond", "eangle", "edihed", "eimp",
                                        "press")]
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
    flex = d / "flex"
    flex.mkdir()
    _, in_flex = chip_smoke.flexible_script_case(str(flex), n_side=(2, 2, 2),
                                                 cut=(4.0, 5.5))
    return {"panel_step": (_SCRIPT, in_fluid, {"LIDP_FAST_POLAR": "1"}),
            "pair_plain": (_PAIR, str(d / "pair_case.npz"), {}),
            "dense_route": (_SCRIPT, in_fluid, {}),
            "cell_route": (_LJ, str(d / "in.lj"), {}),
            "dense_npt_pppm": (_NPT, str(d / "in.npt"), {}),
            "flexible_shake": (_FLEX, in_flex, {})}


# a zygote: imports numpy and torch, computes nothing, and forks a child
# for each request read from stdin ({code, out, arg, env, err}); the child
# sets the request's environment and runs `code` with sys.argv [-c, out,
# arg], its output to the file `err`; the zygote answers each request with
# the child's exit code.  It forks with one thread (OpenBLAS's pool, which
# numpy's import starts, is held to one thread), so no lock is held by a
# thread the child lacks
_ZYGOTE = """\
import json, os, sys, traceback
import numpy
import torch
assert len(os.listdir("/proc/self/task")) == 1
for line in sys.stdin:
    req = json.loads(line)
    pid = os.fork()
    if pid == 0:
        fd = os.open(req["err"], os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
        rc = 0
        try:
            os.environ.update(req["env"])
            sys.argv = ["-c", req["out"], req["arg"]]
            exec(compile(req["code"], "<case>", "exec"),
                 {"__name__": "__main__"})
        except BaseException:
            traceback.print_exc()
            rc = 1
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    _, status = os.waitpid(pid, 0)
    print(json.dumps(os.waitstatus_to_exitcode(status)), flush=True)
"""


class _Zygote:
    """A _ZYGOTE process on torch's default threads or, with one_thread,
    under OMP_NUM_THREADS=1."""

    def __init__(self, one_thread):
        env = {k: v for k, v in os.environ.items()
               if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                            "LIDP_FAST_POLAR")}
        env["PYTHONPATH"] = os.pathsep.join(filter(None, (
            str(ROOT), os.environ.get("PYTHONPATH"))))
        env.update(OMP_WAIT_POLICY="PASSIVE", OPENBLAS_NUM_THREADS="1")
        if one_thread:
            env["OMP_NUM_THREADS"] = "1"
        self.one_thread = one_thread
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _ZYGOTE], env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True)

    def run(self, code, arg, env_extra, out):
        """A child's run of `code` on `arg`: the arrays it saved to out."""
        env = dict(env_extra, ONE_THREAD="1") if self.one_thread \
            else dict(env_extra)
        err = f"{out}.log"
        self.proc.stdin.write(json.dumps(dict(
            code=code, out=str(out), arg=arg, env=env, err=err)) + "\n")
        self.proc.stdin.flush()
        rc = json.loads(self.proc.stdout.readline())
        assert rc == 0, Path(err).read_text()[-3000:]
        return dict(np.load(out))

    def close(self):
        self.proc.stdin.close()
        self.proc.wait(timeout=60)


@pytest.fixture(scope="module")
def zygotes():
    """The one-thread zygote and a queue of PARALLEL default-thread ones."""
    one = _Zygote(one_thread=True)
    many = [_Zygote(one_thread=False) for _ in range(PARALLEL)]
    free = queue.Queue()
    for z in many:
        free.put(z)
    yield one, free
    for z in [one, *many]:
        z.close()


def _run_many(free, code, arg, env, out):
    """A run on the next free default-thread zygote."""
    z = free.get()
    try:
        return z.run(code, arg, env, out)
    finally:
        free.put(z)


@pytest.mark.parametrize("case", ["panel_step", "pair_plain",
                                  "dense_route", "cell_route",
                                  "dense_npt_pppm", "flexible_shake"])
def test_first_float64_evaluation_is_thread_independent(inputs, zygotes,
                                                        case, tmp_path):
    code, arg, env = inputs[case]
    one, free = zygotes
    ref = one.run(code, arg, env, tmp_path / "one.npz")
    with ThreadPoolExecutor(PARALLEL) as pool:
        runs = list(pool.map(
            lambda k: _run_many(free, code, arg, env,
                                tmp_path / f"run{k}.npz"), range(REPEATS)))
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
