"""The port's script front end (lidp_tpu_torch.io.script LammpsScript ->
sim.Simulation -> FastPolarRunner or the dense route's Runner, and
`python -m lidp_tpu_torch`) against the JAX package's (lidp_tpu.io.script
LammpsScript, `python -m lidp_tpu`) on the 375-atom fluid of
polar_bench.synthetic_system(5), written as a LAMMPS data file and input
by chip_smoke.fluid_script_case, float64, 3 steps.

The input has a Bonds section and special_bonds but no bond_style.  With
LIDP_FAST_POLAR=1 both take the panel engine (FastPolarRunner); without
it, the fluid being below DENSE_PATH_MAX_ATOMS, both take the dense route
(the generic Runner, compute_forces with nlist=None).  Each case asserts
the runner type on both sides.

  * cases on the panel engine: fused and LIDP_FAST_POLAR_MODE=host; fix
    rigid/nve molecule and fix nve; `wrapped` (x shifted by +L/2 and
    wrapped, the molecules straddling the faces, their image flags in the
    data file); `kspace_modify gewald 0.3`.  On the dense route: `dense`
    (rigid/nve), `dense_wrapped` (both packages set the bodies up from
    the wrapped x, ROADMAP queue 3), `dense_nve` (fix nve, 2 steps), and
    `above_cap` (LIDP_FAST_POLAR=0 with DENSE_PATH_MAX_ATOMS mocked to 300
    on both sides: the dense route with JAX's warning, and no special
    codes, as JAX builds them up to the cap only).  Bars (BASELINE.md:21):
    every thermo column within rel 1e-8 of max(1, |value|), the final x,
    v and mu within 1e-8 of their largest entry;
  * the PolarizationSettings the two build, field by field;
  * the pair_style grammar's errors raise as in JAX: zodid while
    polar_gs_ranked is on, polar_gs with polar_gs_ranked, a negative
    static_polarizability;
  * replicate 2 1 1 of the wrapped data gives JAX's x, image, mol, type;
  * an unported command, style or keyword raises NotImplementedError
    naming a ROADMAP item; on the dense route, fix rigid/npt's dilate; above a
    mocked cap, the fluid replicated 2 x 2 x 2 (new velocities by
    position) runs on JAX's cell grid with the special correction, Ewald
    and the dense polar term, its rows within rel 1e-8 of JAX's plus
    chip_smoke.CANCEL_REL of what the correction cancels;
  * the port's CLI as a subprocess (`-device cpu`) against the JAX
    package's script engine on the same input (the fused and dense cases'
    runs, which are what `python -m lidp_tpu` runs): with
    LIDP_FAST_POLAR=1 its logged rows agree at rel 1e-7 of max(1,
    |value|); without it (the dense route), logged at 16 digits by
    `thermo_modify format float`, at rel 1e-8.
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
NSTEP = 3
COLS = chip_smoke.G64_COLS
FIX_RIGID = "fix 1 all rigid/nve molecule"


def _text(case):
    """The input of a case: FLUID_SCRIPT with its edits."""
    t = chip_smoke.FLUID_SCRIPT
    if case in ("nve", "dense_nve"):
        t = t.replace(FIX_RIGID, "fix 1 all nve")
    if case == "gewald":
        t = t.replace("kspace_style ewald/disp 1e-4\n",
                      "kspace_style ewald/disp 1e-4\nkspace_modify "
                      "gewald 0.3\n")
    return t


def _env(case):
    if case.startswith("dense"):
        return {"LIDP_FAST_POLAR": ""}
    if case == "above_cap":
        return {"LIDP_FAST_POLAR": "0"}
    env = {"LIDP_FAST_POLAR": "1"}
    if case == "host":
        env["LIDP_FAST_POLAR_MODE"] = "host"
    return env


def _cap(value):
    """DENSE_PATH_MAX_ATOMS mocked to `value` in both packages (the JAX
    script engine's and the port's)."""
    return mock.patch.multiple(jsim, DENSE_PATH_MAX_ATOMS=value), \
        mock.patch.multiple(tfast, DENSE_PATH_MAX_ATOMS=value)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    out = {}
    for wrapped in (False, True):
        d = tmp_path_factory.mktemp("wrapped" if wrapped else "fluid")
        chip_smoke.fluid_script_case(str(d), n_side=5, wrapped=wrapped)
        out[wrapped] = d
    return out


def _run(pkg, d, text, env, nstep=NSTEP):
    """Run `text` in directory d through pkg's LammpsScript (float64; the
    port on the CPU): the script, its log lines."""
    path = d / f"in.{pkg}"
    path.write_text(text)
    lines = []
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64, log=lines.append)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                                 log=lines.append)
    s.variables["nstep"] = str(nstep)
    with mock.patch.dict(os.environ, env):
        if "LIDP_FAST_POLAR_MODE" not in env:
            os.environ.pop("LIDP_FAST_POLAR_MODE", None)
        if not env.get("LIDP_FAST_POLAR"):
            os.environ.pop("LIDP_FAST_POLAR", None)
        s.file(str(path))
    return s, lines


CASES = ("fused", "host", "nve", "wrapped", "gewald", "dense",
         "dense_wrapped", "dense_nve", "above_cap")
PANEL = ("fused", "host", "nve", "wrapped", "gewald")
STEPS = {"dense_nve": 2, "above_cap": 2}
ABOVE_CAP_N = 300


@pytest.fixture(scope="module")
def runs(dirs):
    """Each case through both packages, once: {case: (jax script, port
    script, port log)}."""
    out = {}
    for case in CASES:
        d = dirs[case in ("wrapped", "dense_wrapped")]
        pair = []
        for pkg in ("jax", "torch"):
            caps = _cap(ABOVE_CAP_N if case == "above_cap" else
                        jsim.DENSE_PATH_MAX_ATOMS)
            with caps[0], caps[1]:
                s, lines = _run(pkg, d, _text(case), _env(case),
                                nstep=STEPS.get(case, NSTEP))
            pair.append(s)
        want = "FastPolarRunner" if case in PANEL else "Runner"
        assert type(pair[0]._sim.runner).__name__ == want
        assert type(pair[1]._sim.runner).__name__ == want
        assert type(pair[1]._sim.runner).__module__.startswith(
            "lidp_tpu_torch.")
        out[case] = (*pair, lines)
    return out


def _state(s, pkg):
    sim = s._sim
    n = sim.natoms
    if pkg == "jax":
        return {k: np.asarray(getattr(sim.sys, k))[:n] for k in
                ("x", "v", "mu")}
    return {k: getattr(sim.sys, k)[:n].numpy() for k in ("x", "v", "mu")}


@pytest.mark.parametrize("case", CASES)
def test_thermo_rows_match_jax(runs, case):
    js, ts, _ = runs[case]
    if case in PANEL:
        assert ts._sim.runner.mode == js._sim.runner.mode == (
            "host" if case == "host" else "fused")
    nrows = STEPS.get(case, NSTEP) + 1
    assert len(ts.thermo_rows) == len(js.thermo_rows) == nrows
    for k, (r, g) in enumerate(zip(ts.thermo_rows, js.thermo_rows)):
        assert int(r["step"]) == int(g["step"]) == k
        for c in COLS:
            assert abs(r[c] - g[c]) <= 1e-8 * max(1.0, abs(g[c])), (k, c)


@pytest.mark.parametrize("case", CASES)
def test_final_state_matches_jax(runs, case):
    js, ts, _ = runs[case]
    a, b = _state(ts, "torch"), _state(js, "jax")
    for k in ("x", "v", "mu"):
        np.testing.assert_allclose(a[k], b[k], rtol=0,
                                   atol=1e-8 * np.abs(b[k]).max(),
                                   err_msg=k)


def test_polarization_settings_match_jax(runs):
    js, ts, _ = runs["fused"]
    jp, tp = js._sim.runner.ff.polar, ts._sim.runner.ff.polar
    jd, td = dataclasses.asdict(jp), dataclasses.asdict(tp)
    assert jd == td
    assert td["polar_gs_ranked"] is True and td["polar_gamma"] == 1.03
    assert td["polar_precision"] == 1e-11 and td["use_previous"] is True


def test_gewald_override_reaches_the_pair_and_kspace(runs):
    js, ts, _ = runs["gewald"]
    assert ts._sim.runner.ff.pair.g_ewald == 0.3
    assert ts._sim.runner.ff.ewald.g_ewald == 0.3
    assert float(js._sim.runner.ff.pair.g_ewald) == 0.3
    # kmax follows from the overridden g: the k-vectors equal JAX's
    np.testing.assert_array_equal(
        ts._sim.runner.ff.ewald.hvecs.numpy(),
        np.asarray(js._sim.runner.ff.ewald.hvecs))


GRAMMAR = {
    "zodid_under_ranked": "pair_style lj/cut/coul/long/polarization 6.0 "
                          "6.5 zodid yes",
    "gs_with_ranked": "pair_style lj/cut/coul/long/polarization 6.0 6.5 "
                      "polar_gs yes",
    "negative_alpha": "set type 1 static_polarizability -1.0",
}


@pytest.mark.parametrize("name", list(GRAMMAR))
def test_grammar_errors_raise_as_in_jax(dirs, name):
    head = ("units real\natom_style full\nread_data fluid.data\n")
    msgs = []
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError) as e:
            _run(pkg, dirs[False], head + GRAMMAR[name] + "\n", _env("fused"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_replicate_matches_jax(dirs):
    text = ("units real\natom_style full\nread_data fluid.data\n"
            "replicate 2 1 1\n")
    js, _ = _run("jax", dirs[True], text, _env("fused"))
    ts, _ = _run("torch", dirs[True], text, _env("fused"))
    assert np.abs(ts.data.image).max() > 0      # the data has image flags
    for k in ("x", "image", "mol", "type", "box_hi"):
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k), k)
    np.testing.assert_array_equal(ts._bonds, js._bonds)


# compute temp and fix nvt are ported (tests/test_torch_thermostats.py),
# region block and pair_style lj/cut too (tests/test_torch_script_cells.py),
# fix npt and kspace_style pppm too (tests/test_torch_npt.py,
# tests/test_torch_pppm.py), msm too (tests/test_torch_msm.py),
# bond_style harmonic too
# (tests/test_torch_flexible_script.py), minimize too
# (tests/test_torch_min_script.py), region sphere too
# (tests/test_torch_regions.py), the DREIDING hydrogen bonds
# (tests/test_torch_hbond.py), and chunk/atom
# (tests/test_torch_chunk_computes.py), pair gran/* (tests/
# test_torch_gran_script.py), the local computes
# (tests/test_torch_output_styles.py): their keys keep the test names and
# hold a style that still raises
UNPORTED = {
    "region": "region s sphere 0 0 0 1 rotate v_a 0 0 0 0 0 1",
    "compute": "compute c all temp/deform",
    "minimize": "min_modify line backtrack",
    "fix nvt": "fix 2 all nvt/sllod temp 300 300 100",
    "pair_style lj/cut": "pair_style granular hooke 2000.0 50.0 tangential "
                         "linear_history 571.4 0.5 0.5",
    "kspace_style pppm": "kspace_style pppm/dipole 1e-4",
    "bond_style": "bond_style class2",
    "thermo keyword": "thermo_style custom step cpu",
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_commands_raise(dirs, name):
    text = ("units real\natom_style full\nread_data fluid.data\n"
            + UNPORTED[name] + "\n")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        _run("torch", dirs[False], text, _env("fused"))


def test_dense_route_special_codes_and_warning(runs):
    """The dense route carries the Bonds section's special codes on both
    sides; above the (mocked) cap neither builds them, so the O-H pairs
    take their full LJ term, and both log JAX's warning."""
    for case in ("dense", "above_cap"):
        js, ts, lines = runs[case]
        jcode, tcode = js._sim.runner.ff.sp_code, ts._sim.runner.ff.sp_code
        if case == "dense":
            np.testing.assert_array_equal(tcode.numpy(), np.asarray(jcode))
            assert ts.thermo_rows[0]["evdwl"] < 0
        else:
            assert jcode is None and tcode is None
            assert ts.thermo_rows[0]["evdwl"] > 1e6
            assert any(line.startswith("WARNING: polarization above the "
                                       "dense-path size cap") for line in
                       lines)
        assert ts._sim.sys.x.shape[0] == ts._sim.natoms


def test_small_system_without_fast_polar_raises(dirs):
    """Without LIDP_FAST_POLAR=1 the 375-atom fluid takes the dense route,
    and what the port cannot run there raises, naming its ROADMAP item:
    fix rigid/npt's dilate keyword (queue 1 item 6).  Above a cap
    mocked to 300 atoms under LIDP_FAST_POLAR=0, the fluid replicated 2 x
    2 x 2 (3,000 atoms, a 4 x 4 x 4 grid; `velocity create ... loop geom`
    so that no two atoms stay exactly half a box apart, where the dipole
    tensor's minimum image has no one answer) takes the JAX package's cell
    grid: the pair term on it, the sparse special-bond correction, Ewald
    and the dense polar term, setup and one step, its rows within rel 1e-8
    of max(1, |value|) of JAX's plus chip_smoke.CANCEL_REL of what the
    correction cancels (chip_smoke.cancelled)."""
    text = _text("dense").replace(
        "fix 1 all rigid/nve molecule",
        "fix 1 all rigid/npt molecule temp 300 300 100 iso 1 1 1000 "
        "dilate all")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        _run("torch", dirs[False], text, _env("dense"))
    # new velocities by position: the replicas' copies of an atom then
    # drift apart, where with equal velocities they stay half a box apart
    # and minimum image picks either sign of such a pair's components
    text = _text("dense").replace(
        "read_data fluid.data\n", "read_data fluid.data\nreplicate 2 2 2\n"
        "velocity all create 300.0 4928 loop geom\n")
    caps = _cap(ABOVE_CAP_N)
    pair = []
    with caps[0], caps[1]:
        for pkg in ("jax", "torch"):
            pair.append(_run(pkg, dirs[False], text, _env("above_cap"),
                             nstep=1)[0])
    js, ts = pair
    for s in pair:
        runner = s._sim.runner
        assert type(runner).__name__ == "Runner"
        assert tuple(runner.neighbor_cfg.nbins) == (4, 4, 4)
        assert runner.ff.polar is not None and runner.ff.sp_idx is not None
    assert not bool(ts._sim.nlist.overflow)
    assert len(ts.thermo_rows) == len(js.thermo_rows) == 2
    chip_smoke.rows_agree("above_cap_cells", ts.thermo_rows, js.thermo_rows,
                          [1e-8, 1e-8], cancel=chip_smoke.cancelled(ts._sim))


def _log_rows(path):
    return chip_smoke.log_rows(Path(path).read_text().splitlines())


def _port_cli(d, tmp_path, infile, env):
    """The port's CLI (`-device cpu`) on `infile` in d, NSTEP steps: its
    logged rows."""
    env = dict(os.environ, **env, PYTHONPATH=os.pathsep.join(filter(None, (
        str(ROOT), os.environ.get("PYTHONPATH")))))
    for k in ("LIDP_FAST_POLAR", "LIDP_FAST_POLAR_MODE"):
        if not env.get(k):
            env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-m", "lidp_tpu_torch", "-in", infile, "-var",
         "nstep", str(NSTEP), "-log", str(tmp_path / "log.torch"),
         "-device", "cpu"], cwd=d, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res, _log_rows(tmp_path / "log.torch")


def test_clis_agree(runs, dirs, tmp_path):
    """The port's CLI on in.fluid under LIDP_FAST_POLAR=1 (the panel
    engine), its rows as printed against the JAX package's script engine
    on the same input (the fused case's run) at rel 1e-7."""
    _, tr = _port_cli(dirs[False], tmp_path, "in.fluid",
                      {"LIDP_FAST_POLAR": "1", "OMP_NUM_THREADS": "1"})
    jr = runs["fused"][0].thermo_rows
    assert len(jr) == len(tr) == NSTEP + 1
    for r, g in zip(tr, jr):
        for c in COLS:
            assert abs(r[c] - g[c]) <= 1e-7 * max(1.0, abs(g[c])), c


def test_clis_agree_on_the_dense_route(runs, dirs, tmp_path):
    """The port's CLI without LIDP_FAST_POLAR takes the dense route on the
    375-atom fluid; logged at 16 digits, its rows agree with the JAX
    package's script engine on the same input (the dense case's run) at
    rel 1e-8."""
    d = dirs[False]
    (d / "in.dense16").write_text(chip_smoke.FLUID_SCRIPT.replace(
        "thermo 1\n", "thermo 1\nthermo_modify format float %.16g\n"))
    res, tr = _port_cli(d, tmp_path, "in.dense16", {"OMP_NUM_THREADS": "1"})
    assert "fast-polar engine" not in res.stdout
    jr = runs["dense"][0].thermo_rows
    assert len(jr) == len(tr) == NSTEP + 1
    for r, g in zip(tr, jr):
        for c in COLS:
            assert abs(r[c] - g[c]) <= 1e-8 * max(1.0, abs(g[c])), c
