"""The walls, indent and move of the port (lidp_tpu_torch/styles/
fix_modifiers.py: wall/reflect, wall/lj93, wall/lj126, wall/lj1043,
wall/harmonic, wall/region, indent, move) against the JAX package's
builders (lidp_tpu/styles/fix_modifiers.py), float64 on the CPU, both in
one process:

  * tests/test_walls.py's base (fcc 3^3 cells, 108 atoms, `boundary p p
    f`, velocity create 1.5, fix nve, the dense route) with the fixes
    under test, 20 steps, a row every 5: every row within rel 1e-8 of
    max(1, |value|) of the JAX package's, the final x and v within 1e-8
    of their largest entry; the fixes act (the rows part from the bare
    base's) and the walls confine;
  * test_walls.py's single atom at 1.3 from a 9-3 wall: the force its
    analytic derivative;
  * what JAX refuses, the port refuses: wall/region on a side out region
    or a cone, indent's other geometries, move's NULL components; and
    what JAX skips unread raises, and so does wall/region on a cylinder
    with an INF cap, where JAX's forces are NaN.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402

ROWS = 1e-8
STATE = 1e-8
A0 = (4 / 0.8442) ** (1 / 3) * 3      # the base's box edge

BASE = """units lj
atom_style atomic
boundary p p f
lattice fcc 0.8442
region box block 0 3 0 3 0 3
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
velocity all create 1.5 12345 loop geom
fix 1 all nve
thermo 5
"""
RUN = "run 20\n"

CASES = {
    "bare": "",
    "wall/reflect": f"fix 2 all wall/reflect zlo 0.0 zhi {A0} units box\n",
    "wall/lj93": (f"fix 2 all wall/lj93 zlo -0.8 1.0 1.0 2.5 "
                  f"zhi {A0 + 0.8} 1.0 1.0 2.5\n"),
    "wall/lj126 lj1043": (f"fix 2 all wall/lj126 zlo -0.6 1.0 1.0 2.5\n"
                          f"fix 3 all wall/lj1043 zhi {A0 + 0.6} 1.0 1.0 "
                          "2.5\n"),
    "wall/harmonic": ("group top id 100 101 102 103 104 105 106 107\n"
                      f"fix 2 all wall/harmonic zlo -0.3 2.0 1.0 1.0\n"
                      f"fix 3 top wall/harmonic zhi {A0 - 0.5} 5.0 1.0 "
                      "2.0\n"),
    "wall/region block, indent": (
        "region inner block -0.3 3.3 -0.3 3.3 -0.2 3.2\n"
        "fix 2 all wall/region inner lj93 1.0 1.0 2.5\n"
        "fix 3 all indent 10.0 sphere 1.5 1.5 1.5 0.8\n"),
    "wall/region sphere": ("region ball sphere 1.5 1.5 1.5 2.8\n"
                           "fix 2 all wall/region ball harmonic 3.0 1.0 "
                           "1.2\n"),
    "wall/region cylinder, move": (
        "region can cylinder z 1.5 1.5 2.4 -0.2 3.2\n"
        "fix 2 all wall/region can lj126 1.0 1.0 2.5\n"
        "group a id 1 2 3 4 5 6 7 8 9 10\n"
        "group b id 20 21 22 23 24 25 26 27 28 29 30\n"
        "fix 3 a move linear 0.1 0.0 0.2 units box\n"
        "fix 4 b move wiggle 0.0 0.3 0.0 2.0\n"),
}


def _both(text):
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            s = jscript.LammpsScript(dtype=jnp.float64, log=lambda line: None)
        else:
            s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                                     log=lambda line: None)
        s.execute(text.splitlines())
        out.append(s)
    return out


@pytest.fixture(scope="module")
def bare():
    """The bare base through both packages, once: the "bare" case's runs
    and the reference the other cases part from."""
    return _both(BASE + CASES["bare"] + RUN)


@pytest.mark.parametrize("name", list(CASES))
def test_wall_rows_match_jax(name, bare):
    js, ts = bare if name == "bare" else _both(BASE + CASES[name] + RUN)
    trows, jrows = ts.thermo_rows, js.thermo_rows
    assert [r["step"] for r in trows] == [0, 5, 10, 15, 20]
    for tr, jr in zip(trows, jrows):
        for k, v in tr.items():
            if k in jr and isinstance(v, float):
                assert abs(v - jr[k]) <= ROWS * max(1.0, abs(jr[k])), (
                    tr["step"], k, v, jr[k])
    n = ts._sim.natoms
    for k in ("x", "v"):
        got = getattr(ts._sim.sys, k).numpy()[:n]
        want = np.asarray(getattr(js._sim.sys, k))[:n]
        assert np.abs(got - want).max() <= STATE * np.abs(want).max(), k
    if name == "bare":
        return
    # the fixes act: the run parts from the bare base's
    ref = bare[1]
    assert abs(trows[-1]["etotal"] - ref.thermo_rows[-1]["etotal"]) > 1e-6 \
        or np.abs(ts._sim.sys.x.numpy() - ref._sim.sys.x.numpy()).max() \
        > 1e-6
    z = ts._sim.sys.x.numpy()[:, 2]
    if name == "wall/reflect":
        assert z.min() >= -1e-9 and z.max() <= A0 + 1e-9
    if name == "wall/lj93":
        assert z.min() > -0.6 and z.max() < A0 + 0.6


def test_wall_lj93_force_value():
    """tests/test_walls.py's single static atom at 1.3 from a zlo wall:
    f_z the 9-3 potential's analytic derivative."""
    s = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    s.execute("""units lj
atom_style atomic
boundary p p f
region box block 0 10 0 10 0 10 units box
create_box 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
create_atoms 1 single 5.0 5.0 1.3 units box
fix 1 all nve
fix 2 all wall/lj93 zlo 0.0 1.0 1.0 2.5
run 0""".splitlines())
    fz = float(s._sim.res.f[0, 2])
    d = 1.3
    fref = 9 * 2 / 15 / d**10 - 3 / d**4
    assert abs(fz - fref) < 1e-10, (fz, fref)


# line -> (the port's exception and its message, the JAX package's
# exception, None where JAX skips the line unread)
REFUSALS = {
    "wall/region side out": (
        "region out sphere 1.5 1.5 1.5 2.8 side out\n"
        "fix 2 all wall/region out lj93 1.0 1.0 2.5",
        (NotImplementedError, "side out"), NotImplementedError),
    "wall/region cone": (
        "region c cone z 1.5 1.5 1 2 0 3\n"
        "fix 2 all wall/region c lj93 1.0 1.0 2.5",
        (ValueError, "block, a sphere or a cylinder"), ValueError),
    "indent cylinder": ("fix 2 all indent 10.0 cylinder z 1 1 0.5",
                        (NotImplementedError, "sphere only"),
                        AssertionError),
    "move NULL": ("fix 2 all move linear 0.1 NULL 0.0",
                  (NotImplementedError, "NULL"), NotImplementedError),
    "move rotate": ("fix 2 all move rotate 0 0 0 0 0 1 10",
                    (NotImplementedError, "move rotate"),
                    NotImplementedError),
    "indent variable": ("fix 2 all indent 10.0 sphere v_x 1 1 0.5",
                        (NotImplementedError, "queue 3 item 22"),
                        ValueError),
    "indent side in": ("fix 2 all indent 10.0 sphere 1 1 1 0.5 side in",
                       (NotImplementedError, "queue 3 item 11"), None),
    "move units lattice": ("fix 2 all move linear 0.1 0 0 units lattice",
                           (NotImplementedError, "queue 3 item 11"), None),
    "wall pbc": ("fix 2 all wall/lj93 zlo 0.0 1.0 1.0 2.5 pbc yes",
                 (NotImplementedError, "queue 3 item 11"), None),
    "wall/region cylinder INF": (
        "region can cylinder z 1.5 1.5 2.4 INF INF\n"
        "fix 2 all wall/region can lj126 1.0 1.0 2.5",
        (NotImplementedError, "queue 3 item 22"), None),
    "wall/region morse": (
        "region ball sphere 1.5 1.5 1.5 2.8\n"
        "fix 2 all wall/region ball morse 1.0 1.0 1.0 2.5",
        (NotImplementedError, "item 6.1"), None),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals(name):
    text, (texc, msg), jexc = REFUSALS[name]
    full = (BASE + text + "\nrun 0\n").splitlines()
    with pytest.raises(texc, match=msg):
        tscript.LammpsScript(dtype=torch.float64, device="cpu").execute(full)
    if jexc is not None:
        with pytest.raises(jexc):
            jscript.LammpsScript(dtype=jnp.float64).execute(full)
