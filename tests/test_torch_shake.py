"""The port's fix shake and fix rattle (lidp_tpu_torch/ops/shake.py,
styles/fix_modifiers.py) against the JAX package's, float64 on the CPU.

  * find_clusters on the topology of chip_smoke.flexible_script_case
    (methyl groups: 3-bond clusters, N-H: 2-atom clusters, waters: 2 bonds
    and the angle), by bond type and by mass: equal arrays;
  * build_shake_params, shake_post_force and rattle_velocity on the same
    state (the data file's positions, seeded velocities and forces): the
    params equal, the constrained forces, the constraint virial and the
    projected velocities at rel 1e-10 of their largest entry;
  * a box of 27 TIP3P-like waters (`m 1.008 a 1`, the form of
    examples/peptide's fix) under `fix shake` and under `fix rattle`, each
    with fix nve, through both packages' LammpsScript, 5 steps with a row
    each step: every column at rel 1e-8 of max(1, |value|), the final x
    and v at 1e-8 of their largest entry; each O-H bond and H-H distance
    within the fix's tolerance (1e-4 relative) of its target at the end
    under shake, within 5e-4 under rattle (the JAX package's rattle, ROADMAP
    queue 3 item 14), and under rattle each constraint's relative velocity
    along its bond near zero.
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
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu.ops import shake as jshake  # noqa: E402
from lidp_tpu.state import make_system as jmake  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.io.data_reader import read_data  # noqa: E402
from lidp_tpu_torch.ops import shake as tshake  # noqa: E402
from lidp_tpu_torch.state import make_system  # noqa: E402

TOL = 1e-10
DT, FTM2V = 2.0, 1.0 / 48.88821291 / 48.88821291


@pytest.fixture(scope="module")
def flex(tmp_path_factory):
    d = tmp_path_factory.mktemp("flex")
    data, _ = chip_smoke.flexible_script_case(str(d), n_side=(2, 2, 2),
                                              cut=(4.0, 5.5))
    return read_data(data, atom_style="full")


def _find(pkg, d, **kw):
    mod = jshake if pkg == "jax" else tshake
    br0 = np.array([0.0] + [r0 for _, r0 in chip_smoke.FLEX_BONDS])
    ath0 = np.deg2rad(np.array(
        [0.0] + [a[1] for a in chip_smoke.FLEX_ANGLES.values()]))
    return mod.find_clusters(
        d.natoms, d.bonds - 1, d.bond_types, d.angles - 1, d.angle_types,
        d.mass[d.type], type_atom=d.type, bond_r0=br0, angle_theta0=ath0,
        **kw)


FIND_CASES = {"b": dict(b_types=(1, 5, 7), a_types=(10,)),
              "m": dict(masses=(1.008,), a_types=(10,)),
              "t": dict(t_types=(6,))}


@pytest.mark.parametrize("case", list(FIND_CASES))
def test_find_clusters_matches_jax(flex, case):
    fj = _find("jax", flex, **FIND_CASES[case])
    ft = _find("torch", flex, **FIND_CASES[case])
    assert len(fj) == len(ft) == 7
    for k, (a, b) in enumerate(zip(ft, fj)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"item {k}")
    if case == "b":
        # 16 methyls (3 bonds), 8 N-H, 32 waters (2 bonds + the angle)
        assert ft[4] == 8 * 7 + 32 * 3
        assert np.bincount(ft[3].sum(1)).tolist() == [0, 8, 0, 16 + 32]


def _state(d, seed=9):
    rng = np.random.RandomState(seed)
    n = d.natoms
    return (d.x, rng.normal(0.0, 0.01, (n, 3)),
            rng.normal(0.0, 20.0, (n, 3)))


def _params(d, found):
    m = d.mass[d.type]
    pj = jshake.build_shake_params(n=d.natoms, dt=DT, ftm2v=FTM2V,
                                   mass_atom=m, found=found, tolerance=1e-4,
                                   max_iter=10)
    pt = tshake.build_shake_params(d.natoms, DT, FTM2V, m, found,
                                   tolerance=1e-4, max_iter=10)
    return pj, pt


def test_shake_and_rattle_match_jax(flex):
    d = flex
    found = _find("jax", d, **FIND_CASES["b"])
    pj, pt = _params(d, found)
    fields = {f.name: getattr(pj, f.name) for f in dataclasses.fields(pj)}
    pc = convert.bonded_from_numpy(
        tshake.ShakeParams, {k: np.array(v) for k, v in fields.items()},
        device="cpu")
    for p in (pt, pc):
        for name, v in fields.items():
            got = getattr(p, name)
            got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=name)
    x, v, f = _state(d)
    from lidp_tpu.box import Box as JBox

    from lidp_tpu_torch.box import Box
    sj = jmake(x, box=JBox.create(d.box_lo, d.box_hi, dtype=jnp.float64),
               v=v, dtype=jnp.float64)
    st = make_system(x, box=Box.create(d.box_lo, d.box_hi,
                                       dtype=torch.float64),
                     v=v, dtype=torch.float64, device="cpu")
    fj, vj = jshake.shake_post_force(sj, jnp.asarray(f), pj)
    ftt, vt = tshake.shake_post_force(st, torch.as_tensor(f), pt)
    for name, a, b in (("f", ftt, fj), ("virial", vt, vj)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=TOL * np.abs(b).max(), err_msg=name)
    # the constraint forces move the predicted positions onto the bonds
    assert float((ftt - torch.as_tensor(f)).abs().max()) > 1.0
    rj = jshake.rattle_velocity(sj, pj).v
    rt = tshake.rattle_velocity(st, pt).v
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=TOL * np.abs(np.asarray(rj)).max())


# ------------------------------ water box ---------------------------------

WATER = """\
units real
atom_style full
boundary p p p
bond_style harmonic
angle_style harmonic
pair_style lj/cut/coul/long 4.5 4.5
kspace_style ewald 1.0e-4
read_data water.data
pair_coeff 1 1 0.1521 3.1507
pair_coeff 2 2 0.0 1.0
bond_coeff 1 450.0 0.9572
angle_coeff 1 55.0 104.52
special_bonds lj/coul 0.0 0.0 0.0
fix 1 all {fix} 0.0001 20 0 m 1.008 a 1
fix 2 all nve
timestep 1.0
thermo 1
thermo_style custom step temp epair emol etotal press pe ke ebond eangle
run 5
"""


def _water_data(path, seed=1, k=3, s=3.1):
    """k^3 waters (TIP3P geometry and charges) on a grid of spacing s,
    turned at random, seeded velocities."""
    rng = np.random.RandomState(seed)
    th = np.deg2rad(104.52)
    h = 0.9572 * np.array([[np.cos(th / 2), np.sin(th / 2), 0.0],
                           [np.cos(th / 2), -np.sin(th / 2), 0.0]])
    L = k * s
    lines = ["water", "", f"{3 * k ** 3} atoms", f"{2 * k ** 3} bonds",
             f"{k ** 3} angles", "2 atom types", "1 bond types",
             "1 angle types", ""]
    lines += [f"0.0 {L!r} {a}lo {a}hi" for a in "xyz"]
    lines += ["", "Masses", "", "1 15.9994", "2 1.008", "", "Atoms # full",
              ""]
    atoms = []
    for m in range(k ** 3):
        o = s * (np.array([m % k, (m // k) % k, m // k // k]) + 0.5)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        for t, qq, xx in ((1, -0.834, o), (2, 0.417, o + q @ h[0]),
                          (2, 0.417, o + q @ h[1])):
            atoms.append(f"{len(atoms) + 1} {m + 1} {t} {qq} "
                         + " ".join(repr(float(c)) for c in xx))
    lines += atoms + ["", "Velocities", ""]
    v = rng.normal(0.0, 0.004, (3 * k ** 3, 3))
    lines += [f"{i + 1} " + " ".join(repr(float(c)) for c in v[i])
              for i in range(3 * k ** 3)]
    lines += ["", "Bonds", ""]
    lines += [f"{2 * m + b + 1} 1 {3 * m + 1} {3 * m + b + 2}"
              for m in range(k ** 3) for b in range(2)]
    lines += ["", "Angles", ""]
    lines += [f"{m + 1} 1 {3 * m + 2} {3 * m + 1} {3 * m + 3}"
              for m in range(k ** 3)]
    path.write_text("\n".join(lines) + "\n")


def _run(pkg, d, fix):
    (d / f"in.{fix}").write_text(WATER.format(fix=fix))
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    env = {k: v for k, v in os.environ.items() if k != "LIDP_FAST_POLAR"}
    with mock.patch.dict(os.environ, env, clear=True):
        s.file(str(d / f"in.{fix}"))
    return s


@pytest.fixture(scope="module")
def water(tmp_path_factory):
    d = tmp_path_factory.mktemp("water")
    _water_data(d / "water.data")
    return {fix: tuple(_run(pkg, d, fix) for pkg in ("jax", "torch"))
            for fix in ("shake", "rattle")}


@pytest.mark.parametrize("fix", ["shake", "rattle"])
def test_water_box_matches_jax(water, fix):
    js, ts = water[fix]
    sim = ts._sim
    assert sim.runner.post_force is not None and sim.runner.every_step_ev
    assert (sim.runner.end_of_step is not None) == (fix == "rattle")
    # the constrained bonds and angle leave the bonded terms
    assert sim.runner.ff.bond == () and sim.runner.ff.angle == ()
    cols = [c for c in ts.thermo_columns if c != "step"]
    assert len(ts.thermo_rows) == len(js.thermo_rows) == 6
    chip_smoke.rows_agree(fix, ts.thermo_rows, js.thermo_rows, [1e-8] * 6,
                          cols=cols)
    n = sim.natoms
    for k in ("x", "v"):
        a = getattr(sim.sys, k)[:n].numpy()
        b = np.asarray(getattr(js._sim.sys, k))[:n]
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-8 * np.abs(b).max(), err_msg=k)
    x = sim.sys.x.numpy()
    L = sim.sys.box.lengths.numpy()

    def dist(a, b):
        d = x[a::3] - x[b::3]
        return np.linalg.norm(d - L * np.round(d / L), axis=1)

    th = np.deg2rad(104.52)
    hh = 2.0 * 0.9572 * np.sin(th / 2)
    # rattle's positions drift further: the JAX package's rattle predicts
    # with shake's dt^2 ftm2v, where fix_shake.cpp takes half of it under
    # rattle (ROADMAP queue 3 item 14); the port reproduces it
    bar = 1e-4 if fix == "shake" else 5e-4
    for got, want in ((dist(0, 1), 0.9572), (dist(0, 2), 0.9572),
                      (dist(1, 2), hh)):
        assert np.abs(got / want - 1.0).max() < bar
    if fix == "rattle":
        v = sim.sys.v.numpy()
        for a, b in ((0, 1), (0, 2), (1, 2)):
            d = x[a::3] - x[b::3]
            d = d - L * np.round(d / L)
            dv = v[a::3] - v[b::3]
            along = np.abs((d * dv).sum(1)) / np.linalg.norm(d, axis=1)
            assert along.max() < 1e-6 * np.abs(v).max() + 1e-12
