"""The modifier fixes of lidp_tpu_torch/styles/fix_modifiers.py against
the JAX package's (lidp_tpu/styles/fix_modifiers.py and the composition
of lidp_tpu/sim.py), float64 on the CPU, both sides in one process:

  * each hook on its own: the 375-atom point-charge fluid, wrapped (image
    flags of +-1), with `fix 1 all nve` and the fix under test on a
    sub-group, built by both packages' Simulation.from_script; the hook
    the Runner composes (post_force and its setup variant, or
    end_of_step) applied to the same System arrays (the JAX System
    converted with lidp_tpu_torch.convert), random velocities and forces
    from a seed, at steps 0 and 3: the forces and the virial, or v and x,
    within 1e-12 of their largest entry; momentum also at a step it
    skips;
  * one short script per family, 3 steps with a row each, the JAX
    package's LammpsScript (what its CLI runs) against the port's, rows
    within rel 1e-8 of max(1, |value|), final x and v within 1e-8 of
    their largest entry:
      - post_force: the fluid under fix nve with setforce, langevin,
        addforce, aveforce, spring/self, viscous, efield, spring tether
        and couple, planeforce and lineforce, each on a group of its own
        (langevin and viscous make the Runner evaluate every step:
        every_step_ev, JAX's has_vdep_pf);
      - end_of_step: flexible molecules (chip_smoke.flexible_script_case
        at 192 atoms, lj/charmm/coul/charmm, no k-space) under fix nve and
        fix rattle with momentum, recenter and temp/csld after it: the
        order rattle, the end_of_step hooks, the temperature fix;
      - the temperature fixes: the same molecules under fix shake with
        temp/rescale and temp/berendsen on a group that holds some of the
        shake clusters whole and cuts others (its dof loses only the
        whole ones), and the rigid fluid under temp/berendsen (a rigid
        fix's dof, all or nothing);
  * the styles left out raise NotImplementedError naming their ROADMAP
    item, and so do keywords the JAX builders skip unread: since the
    walls, indent and move are ported, their cases hold what of them
    still raises (a wall face at EDGE, indent's cylinder, move's NULL
    component, fix_modify temp on a fix that reads no temperature).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time, as the port's other parity files: under
# pytest-xdist torch's threads spin on the cores the other workers use
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu import sim as jsim  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch import sim as tsim  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402

HOOK = 1e-12
ROWS = 1e-8
STATE = 1e-8
NSTEP = 3

HEAD = """\
units real
atom_style full
read_data fluid.data
pair_style lj/cut 5.0
pair_coeff * * 0.1 3.0
group a molecule <= 20
group b molecule > 100
group h type 2
timestep 0.5
fix 1 all nve
"""

# style -> (family, the fix line's group and arguments)
HOOKS = {
    "setforce": ("pf", "a setforce 0.0 NULL 1.5"),
    "langevin": ("pf", "a langevin 300.0 300.0 100.0 904297"),
    "addforce": ("pf", "b addforce 0.1 -0.2 0.3"),
    "aveforce": ("pf", "a aveforce NULL 0.5 0.0"),
    "spring/self": ("pf", "b spring/self 2.0"),
    "viscous": ("pf", "h viscous 0.05"),
    "efield": ("pf", "all efield 0.01 0.0 -0.02"),
    "spring tether": ("pf", "a spring tether 5.0 1.0 NULL 2.0 0.5"),
    "spring couple": ("pf", "a spring couple b 5.0 1.0 1.0 NULL 0.5"),
    "planeforce": ("pf", "h planeforce 1 1 0"),
    "lineforce": ("pf", "h lineforce 0 1 1"),
    "momentum": ("eos", "a momentum 2 linear 1 0 1"),
    "recenter": ("eos", "b recenter INIT NULL 3.0"),
    "temp/csld": ("eos", "a temp/csld 300.0 300.0 100.0 4567"),
    "temp/rescale": ("eos", "a temp/rescale 1 300.0 300.0 1.0 0.5"),
    "temp/berendsen": ("eos", "all temp/berendsen 300.0 300.0 100.0"),
}


@pytest.fixture(scope="module")
def fluid(tmp_path_factory):
    d = tmp_path_factory.mktemp("modifier_fluid")
    chip_smoke.fluid_script_case(str(d), n_side=5, wrapped=True)
    return d


def _script(pkg, directory, text):
    path = Path(directory) / f"in.{pkg}"
    path.write_text(text)
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64, log=lambda line: None)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                                 log=lambda line: None)
    s.file(str(path))
    return s


def _hooks_case(fluid, name):
    """Both packages' Simulations of HEAD with the fix under test."""
    text = HEAD + f"fix m {HOOKS[name][1]}\n"
    js, ts = _script("jax", fluid, text), _script("torch", fluid, text)
    return jsim.Simulation.from_script(js), tsim.Simulation.from_script(ts)


def _state(jsys, seed):
    """Random positions near the System's (the tethers then pull), random
    velocities and forces."""
    rng = np.random.default_rng(seed)
    n = jsys.x.shape[0]
    return (np.asarray(jsys.x) + 0.1 * rng.standard_normal((n, 3)),
            0.01 * rng.standard_normal((n, 3)), rng.standard_normal((n, 3)))


def _to_port(jsys):
    return convert.system_from_numpy(
        dict({k: np.asarray(getattr(jsys, k)) for k in
              ("x", "v", "q", "type", "mol", "alpha", "mu", "image",
               "mask")}, box=dict(lo=np.asarray(jsys.box.lo),
                                  hi=np.asarray(jsys.box.hi))), device="cpu")


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= HOOK * scale, f"{what}: {err!r} of {scale!r}"


@pytest.mark.parametrize("name", list(HOOKS))
def test_hook_matches_jax(fluid, name):
    jsm, tsm = _hooks_case(fluid, name)
    family = HOOKS[name][0]
    jr, tr = jsm.runner, tsm.runner
    assert tr.every_step_ev == jr.every_step_ev
    assert tr.every_step_ev == (name in ("langevin", "viscous"))
    for k in ("x", "v", "q", "type", "mol", "image", "mask"):
        assert np.array_equal(getattr(tsm.sys, k).numpy(),
                              np.asarray(getattr(jsm.sys, k))), k
    x, v, f = _state(jsm.sys, seed=len(name))
    jsys = jsm.sys.replace(x=jnp.asarray(x), v=jnp.asarray(v))
    tsys = _to_port(jsys)
    for step in (0, 3):
        js_, ts_ = jsys.replace(step=step), tsys.replace(step=step)
        if family == "pf":
            # one hook for the run and its setup pass
            assert tr.post_force_setup is None
            jf, jv = jr.post_force(js_, jnp.asarray(f))
            tf, tv = tr.post_force(ts_, torch.as_tensor(f))
            _close(tf, jf, f"{name} step {step} f")
            assert not np.any(np.asarray(jv)) and not torch.any(tv)
            assert not torch.equal(tf, torch.as_tensor(f))
        else:
            jo, to = jr.end_of_step(js_, None), tr.end_of_step(ts_, None)
            for k in ("x", "v"):
                _close(getattr(to, k), getattr(jo, k),
                       f"{name} step {step} {k}")
            moved = not (torch.equal(to.v, ts_.v) and torch.equal(to.x,
                                                                   ts_.x))
            # momentum acts every 2 steps: step 3 leaves the state alone
            assert moved == (name != "momentum" or step % 2 == 0)


# --------------------------- the script families -------------------------

def _flex(directory, fixes, shake):
    """flexible_script_case at 192 atoms without k-space: `fix 1 all nve`,
    `fix 2 all <shake>` and `fixes` after them, a row each step."""
    chip_smoke.flexible_script_case(
        str(directory), n_side=(2, 2, 2), cut=(4.0, 5.5),
        pair="lj/charmm/coul/charmm 4.0 5.5", kspace=None)
    text = chip_smoke.flexible_script(
        "nve", cut=(4.0, 5.5), pair="lj/charmm/coul/charmm 4.0 5.5",
        kspace=None, shake=shake)
    return text.replace("run ${nstep}", fixes + f"run {NSTEP}")


# a group that holds the water and N-H clusters whole and the CT-H bonds
# cut (HA in it, CT not)
TGROUP = "group tg type 2 5 6 7 8\n"


def _pf_family(d):
    """The fluid under fix nve with every post_force style, each on a group
    of its own."""
    chip_smoke.fluid_script_case(str(d), n_side=5, wrapped=True)
    groups = ("group c molecule == 50\ngroup d molecule >= 90\n"
              "group e id 7 8 9 10 11 12 13 14 15\n"
              "group k molecule < 5\n")
    fixes = ("c setforce 0.0 NULL 1.5", "a langevin 300.0 300.0 100.0 904297",
             "b addforce 0.1 -0.2 0.3", "d aveforce NULL 0.5 0.0",
             "e spring/self 2.0", "h viscous 0.05",
             "all efield 0.01 0.0 -0.02",
             "a spring couple b 5.0 1.0 1.0 NULL 0.5",
             "k planeforce 1 1 0")
    return (HEAD + groups
            + "".join(f"fix p{k} {f}\n" for k, f in enumerate(fixes))
            + f"thermo_style custom step etotal ke pe temp press\n"
            f"thermo 1\nrun {NSTEP}\n")


FAMILIES = {
    "post_force": _pf_family,
    "end_of_step": lambda d: _flex(
        d, "group tg type 7 8\nfix 3 all momentum 1 linear 1 1 1\n"
           "fix 4 tg recenter INIT INIT INIT\n"
           "fix 5 tg temp/csld 275.0 275.0 100.0 321\n",
        "rattle 0.0001 10 100 b 1 5 7 a 10"),
    "temp/rescale": lambda d: _flex(
        d, TGROUP + "fix 3 tg temp/rescale 1 250.0 250.0 0.5 0.8\n",
        chip_smoke.FLEX_SHAKE),
    "temp/berendsen": lambda d: _flex(
        d, TGROUP + "fix 3 tg temp/berendsen 250.0 250.0 20.0\n",
        chip_smoke.FLEX_SHAKE),
    "rigid": lambda d: _rigid_family(d),
}


def _rigid_family(d):
    chip_smoke.fluid_script_case(str(d), n_side=5)
    return (chip_smoke.point_charge_script()
            .replace("run ${nstep}", "fix 2 all temp/berendsen 250.0 250.0 "
                     f"10.0\nrun {NSTEP}"))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_rows_match_jax(tmp_path, name):
    text = FAMILIES[name](tmp_path)
    js, ts = _script("jax", tmp_path, text), _script("torch", tmp_path, text)
    rows, ref = ts.thermo_rows, js.thermo_rows
    assert len(rows) == len(ref) == NSTEP + 1
    cols = [c for c in ts.thermo_columns if c != "step"]
    chip_smoke.rows_agree(name, rows, ref, [ROWS] * len(ref), cols=cols)
    n = ts._sim.natoms
    for k in ("x", "v"):
        a = getattr(ts._sim.sys, k)[:n].numpy()
        b = np.asarray(getattr(js._sim.sys, k))[:n]
        np.testing.assert_allclose(a, b, rtol=0, atol=STATE * np.abs(b).max(),
                                   err_msg=k)
    assert ts._sim.runner.every_step_ev == js._sim.runner.every_step_ev
    if name == "post_force":
        assert ts._sim.runner.every_step_ev
    # the temperature fixes act: the KE moves off plain nve's
    if name != "post_force":
        assert ts._sim.runner.end_of_step is not None


def test_temp_group_cuts_some_clusters(tmp_path):
    """The temperature families' group holds some shake constraints whole
    (both atoms in it: its dof loses them) and cuts others (it keeps
    them), so their rows test the dof rule of JAX's sim.py:1846-1869."""
    from lidp_tpu_torch.styles.fix_modifiers import shake_pre_pass

    text = FAMILIES["temp/berendsen"](tmp_path)
    ts = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                              log=lambda line: None)
    (tmp_path / "in.dof").write_text(text.replace(f"run {NSTEP}", ""))
    ts.file(str(tmp_path / "in.dof"))
    at, cp, _, cm = shake_pre_pass(ts, ts.mass_type[ts.type])[0][:4]
    pa, qa = (np.take_along_axis(np.maximum(at, 0),
                                 np.maximum(cp[:, :, k], 0), 1)[cm]
              for k in (0, 1))
    tg = ts.groups["tg"]
    assert np.count_nonzero(tg[pa] & tg[qa]) > 0
    assert np.count_nonzero(tg[pa] ^ tg[qa]) > 0


# ------------------------------ refusals -------------------------------

UNPORTED = {
    "temp/csvr": ("fix t all temp/csvr 300 300 100 54321", "item 6.1"),
    "press/berendsen": ("fix t all press/berendsen iso 1 1 1000",
                        "item 6.1"),
    "wall/lj93": ("fix t all wall/lj93 xlo EDGE 1.0 1.0 2.5", "item 6.1"),
    "indent": ("fix t all indent 10.0 cylinder z 0 0 2.0", "item 6.1"),
    "move": ("fix t a move linear NULL 0 1", "item 6.1"),
    "drag": ("fix t a drag 0 0 0 1.0 0.5", "item 6.1"),
    "halt": ("fix t all halt 10 tlimit > 100", "item 6.1"),
    "heat": ("fix t a heat 1 1.0", "item 6.1"),
    "ehex": ("fix t a ehex 1 1.0", "item 6.1"),
    "store/force": ("fix t all store/force", "item 6.1"),
    "dt/reset": ("fix t all dt/reset 1 NULL 1.0 0.1", "item 6.1"),
    "box/relax": ("fix t all box/relax iso 0.0 nreset 10",
                  "item 6.1.*queue 3 item 11"),
    "deform": ("fix t all deform 1 x scale 1.1", "item 6.1"),
    # fix external is ported (tests/test_torch_external.py): an argument
    # the JAX builder does not read still raises
    "external": ("fix t all external pf/array 1 extra",
                 "item 6.1.*queue 3 item 11"),
    "fix_modify": ("fix_modify 1 temp thermo_temp", "item 6.1"),
    # chunk/atom and the local computes are ported
    # (tests/test_torch_chunk_computes.py, tests/test_torch_output_styles.py):
    # the case keeps its name and holds a compute style that still raises
    "compute": ("compute c all temp/deform", "item 6.1"),
    "langevin keyword": ("fix t all langevin 300 300 100 5 zero yes",
                         "item 6.1.*queue 3 item 11"),
    "momentum angular": ("fix t all momentum 1 linear 1 1 1 angular",
                         "item 6.1.*queue 3 item 11"),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_styles_raise(fluid, name):
    line, item = UNPORTED[name]
    text = HEAD + line + "\nrun 0\n"
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP queue 1 {item}"):
        _script("torch", fluid, text)
