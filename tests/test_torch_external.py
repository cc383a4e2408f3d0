"""fix external and its library calls (lidp_tpu_torch/styles/fix_modifiers.py
build_external, lidp_tpu_torch/api.py set_fix_external_callback and
fix_external_set_force) on the CPU in float64:

  * pf/array and pf/callback through both packages' api.lammps on
    tests/test_controller_molecule.py's 32-atom melt, one JAX run each
    (module fixture): the thermo rows within rel 1e-8 of max(1, |value|)
    of JAX's, the callback called on the same steps with the same
    positions and ids;
  * that test file's LAMMPS-side checks through the port: pf/array equal
    to fix addforce on a group, pf/callback with a spring callback equal to
    fix spring/self, fired on every step with changing positions;
  * Ncall and Napply, and what the port refuses.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from lidp_tpu import api as japi  # noqa: E402
from lidp_tpu_torch import api as tapi  # noqa: E402

BASE = """units lj
atom_style atomic
boundary p p p
lattice fcc 0.8442
region box block 0 2 0 2 0 2
create_box 1 box
create_atoms 1 box
mass 1 1.0
velocity all create 1.0 87287 loop geom
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0
fix 1 all nve
thermo 2
thermo_style custom step temp pe ke etotal press
"""
GROUP = "region half block 0 1 INF INF INF INF\ngroup half region half\n"
REL = 1e-8
GRID = "fix e all external pf/callback 2 3"
COLS = ("temp", "pe", "ke", "etotal", "press")


def _lammps(pkg):
    if pkg == "jax":
        return japi.lammps()
    return tapi.lammps(device="cpu")


def _array_run(pkg, fix, force=None, steps=4):
    L = _lammps(pkg)
    L.commands_string(BASE + GROUP + fix + "\n")
    if force is not None:
        L.fix_external_set_force("e", np.tile(force, (L.get_natoms(), 1)))
    L.command(f"run {steps}")
    return L


def _callback_run(pkg, fix="fix e all external pf/callback 1 1", steps=6,
                  k=0.5):
    L = _lammps(pkg)
    L.commands_string(BASE + fix + "\n")
    x0 = np.array(L.lmp.x, float)
    calls = []

    def cb(caller, step, nlocal, ids, x, fext):
        calls.append((int(step), int(nlocal), np.array(ids), np.array(x),
                      caller))
        fext[:] = -k * (x - x0)

    L.set_fix_external_callback("e", cb, caller="me")
    L.command(f"run {steps}")
    return L, calls


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's pf/array and pf/callback runs, once."""
    arr = _array_run("jax", "fix e half external pf/array 1",
                     [0.3, -0.2, 0.1])
    cb, calls = _callback_run("jax")
    grid, gcalls = _callback_run("jax", GRID)
    return {"array": (arr.lmp.thermo_rows, arr.get_thermo("pe")),
            "callback": (cb.lmp.thermo_rows, cb.get_thermo("pe"), calls),
            "grid": (grid.lmp.thermo_rows, grid.get_thermo("pe"), gcalls)}


def _rows_close(trows, jrows):
    assert [int(r["step"]) for r in trows] == [int(r["step"])
                                               for r in jrows]
    for t, j in zip(trows, jrows):
        for c in COLS:
            assert abs(t[c] - float(j[c])) <= REL * max(1.0, abs(float(
                j[c]))), (t["step"], c)


def test_array_matches_jax(jax_runs):
    L = _array_run("torch", "fix e half external pf/array 1",
                   [0.3, -0.2, 0.1])
    jrows, jpe = jax_runs["array"]
    _rows_close(L.lmp.thermo_rows, jrows)
    assert abs(L.get_thermo("pe") - jpe) <= REL * abs(jpe)


def test_callback_matches_jax(jax_runs):
    L, calls = _callback_run("torch")
    jrows, jpe, jcalls = jax_runs["callback"]
    _rows_close(L.lmp.thermo_rows, jrows)
    assert abs(L.get_thermo("pe") - jpe) <= REL * abs(jpe)
    assert [c[0] for c in calls] == [c[0] for c in jcalls]
    for (s, n, ids, x, caller), (_, jn, jids, jx, _) in zip(calls, jcalls):
        assert n == jn == 32 and caller == "me"
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(x, jx, rtol=0, atol=1e-12)


def test_array_is_addforce():
    """tests/test_controller_molecule.py::test_fix_external_pf_array:
    pf/array with a uniform array on a group is fix addforce (rel 1e-12),
    and not a no-op."""
    pe_ext = _array_run("torch", "fix e half external pf/array 1",
                        [0.3, -0.2, 0.1]).get_thermo("pe")
    pe_add = _array_run("torch",
                        "fix e half addforce 0.3 -0.2 0.1").get_thermo("pe")
    pe_none = _array_run("torch", "").get_thermo("pe")
    assert pe_ext == pytest.approx(pe_add, rel=1e-12)
    assert abs(pe_ext - pe_none) > 1e-10


def test_callback_is_spring_self():
    """tests/test_controller_molecule.py::
    test_fix_external_pf_callback_per_step: the callback fires on every
    step 0-6 with the positions of that step, and -K (x - x0) is fix
    spring/self K (rel 1e-9)."""
    L, calls = _callback_run("torch")
    steps = [c[0] for c in calls]
    assert set(range(0, 7)) <= set(steps)
    by_step = {c[0]: c[3] for c in calls}
    assert np.abs(by_step[6] - by_step[1]).max() > 1e-6
    L2 = tapi.lammps(device="cpu")
    L2.commands_string(BASE + "fix e all spring/self 0.5\n")
    L2.command("run 6")
    assert L.get_thermo("pe") == pytest.approx(L2.get_thermo("pe"),
                                               rel=1e-9)


def test_ncall_napply_match_jax(jax_runs):
    """pf/callback Ncall 2 Napply 3: the callback on the steps of the
    Ncall grid, its forces kept between calls and added on the Napply
    grid, as JAX's."""
    L, calls = _callback_run("torch", GRID)
    jrows, jpe, jcalls = jax_runs["grid"]
    assert sorted({c[0] for c in calls}) == [0, 2, 4, 6]
    assert [c[0] for c in calls] == [c[0] for c in jcalls]
    _rows_close(L.lmp.thermo_rows, jrows)
    assert abs(L.get_thermo("pe") - jpe) <= REL * abs(jpe)


REFUSALS = {
    "pf/array Napply": ("fix e all external pf/array 2", NotImplementedError,
                        "queue 3 item 48"),
    "mode": ("fix e all external pf/other 1", ValueError, "pf/other"),
    "keyword": ("fix e all external pf/callback 1 1 extra",
                NotImplementedError, "queue 3 item 11"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals(name):
    line, exc, match = REFUSALS[name]
    L = tapi.lammps(device="cpu")
    L.commands_string(BASE + line + "\n")
    with pytest.raises(exc, match=match):
        L.command("run 1")


def test_library_calls_need_a_fix_external():
    L = tapi.lammps(device="cpu")
    L.commands_string(BASE)
    with pytest.raises(ValueError, match="not a fix external"):
        L.set_fix_external_callback("1", lambda *a: None)
    with pytest.raises(ValueError, match="not a fix external"):
        L.fix_external_set_force("1", np.zeros((32, 3)))
