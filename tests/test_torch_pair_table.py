"""pair_write and pair_style table in the port (lidp_tpu_torch/io/script.py
cmd_pair_write, _read_pair_table; styles/pair_builders.py
_build_table_pair; ops/pair.py table_terms) against the JAX package's,
float64 on the CPU (tests/test_pair_table.py's setup: an fcc box of 108
atoms under lj/cut 2.5):

  * pair_write's file byte for byte equal to JAX's, for lj/cut (r and rsq
    spacing, a KEYWORD per section, two sections appended) and for a
    born/coul/long dimer table with charges (equal to rel 1e-12 where
    XLA's exp and torch's part in the last bits);
  * the table's grid equal to JAX's (rel 1e-15) and the rows of a short
    run through it at rel 1e-8 of max(1, |value|) of JAX's;
  * the round trip (tests/test_pair_table.py's bars): the tabulated
    lj/cut's E_pair within 2e-5 of the analytic one and its forces within
    1e-3 of max |f|, after 5 steps.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin on
# the cores the other workers use
torch.set_num_threads(1)

from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402

SETUP_LJ = """units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 3 0 3 0 3
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
fix 1 all nve
"""
TABLE = ("pair_style table linear 2000\n"
         "pair_coeff 1 1 lj.table LJ11 2.5")


def _script(pkg, d, lines):
    s = (jscript.LammpsScript(dtype=jnp.float64) if pkg == "jax"
         else tscript.LammpsScript(dtype=torch.float64, device="cpu"))
    s.root = str(d)
    s.execute(lines.strip().splitlines())
    return s


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """lj.table written by each package (two sections: LJ11 on r, LJR on
    rsq) in a directory of its own."""
    out = {}
    for pkg in ("jax", "torch"):
        d = tmp_path_factory.mktemp(pkg)
        s = _script(pkg, d, SETUP_LJ)
        s.one("pair_write 1 1 2000 r 0.8 2.5 lj.table LJ11")
        s.one("pair_write 1 1 500 rsq 0.9 2.4 lj.table LJR")
        out[pkg] = d
    return out


def test_pair_write_equals_jax(tables):
    a = (tables["torch"] / "lj.table").read_bytes()
    b = (tables["jax"] / "lj.table").read_bytes()
    assert a.count(b"\nN ") == 2
    assert a == b


def test_pair_write_born_coul_long(tmp_path):
    """A two-type born/coul/long table with charges and the k-space
    g_ewald: the same rows, numbers within rel 1e-12."""
    text = """units metal
atom_style charge
region box block 0 20 0 20 0 20 units box
create_box 2 box
create_atoms 1 single 1 1 1 units box
create_atoms 2 single 5 5 5 units box
mass * 20.0
set type 1 charge 1.0
set type 2 charge -1.0
pair_style born/coul/long 9.0
pair_coeff 1 1 0.2637 0.317 2.340 1.0486 -0.4993
pair_coeff 1 2 0.2110 0.317 2.755 6.9906 -8.6758
pair_coeff 2 2 0.1582 0.317 3.170 75.0547 -150.7520
kspace_style ewald 1e-5
fix 1 all nve
"""
    rows = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        s = _script(pkg, d, text)
        s.one("pair_write 1 2 300 r 1.5 9.5 nacl.table NACL12 1.0 -1.0")
        lines = (d / "nacl.table").read_text().splitlines()
        rows[pkg] = lines
    assert len(rows["jax"]) == len(rows["torch"]) == 305
    for a, b in zip(rows["torch"], rows["jax"]):
        ta, tb = a.split(), b.split()
        if len(tb) == 4 and tb[0].isdigit():
            np.testing.assert_allclose([float(v) for v in ta],
                                       [float(v) for v in tb], rtol=1e-12,
                                       atol=1e-300)
        else:
            assert a == b


def test_table_run_matches_jax(tables):
    runs = {}
    for pkg in ("jax", "torch"):
        s = _script(pkg, tables["torch"], SETUP_LJ.replace(
            "pair_style lj/cut 2.5\npair_coeff 1 1 1.0 1.0 2.5", TABLE))
        s.one("velocity all create 1.0 99 loop geom")
        s.one("thermo 1")
        s.one("run 5")
        runs[pkg] = s
    pt = runs["torch"]._sim.runner.ff.pair
    pj = runs["jax"]._sim.runner.ff.pair
    assert pt.kind == pj.kind == "table"
    np.testing.assert_allclose(pt.tab_e.numpy(), np.asarray(pj.tab_e),
                               rtol=1e-15)
    np.testing.assert_allclose(pt.tab_f.numpy(), np.asarray(pj.tab_f),
                               rtol=1e-15)
    assert pt.tab_dr == pytest.approx(float(pj.tab_dr), rel=1e-15)
    assert runs["torch"]._sim.runner.neighbor_cfg is None
    for a, b in zip(runs["torch"].thermo_rows, runs["jax"].thermo_rows):
        for c in ("temp", "pe", "etotal", "press"):
            assert abs(a[c] - b[c]) <= 1e-8 * max(1.0, abs(b[c])), c


def test_pair_write_roundtrip(tables):
    """tests/test_pair_table.py's round trip through the port."""
    s1 = _script("torch", tables["torch"], SETUP_LJ)
    s2 = _script("torch", tables["torch"], SETUP_LJ.replace(
        "pair_style lj/cut 2.5\npair_coeff 1 1 1.0 1.0 2.5", TABLE))
    for s_ in (s1, s2):
        s_.one("velocity all create 1.0 99 loop geom")
        s_.one("run 5")
    r1, r2 = s1.thermo_rows[-1], s2.thermo_rows[-1]
    assert abs(r1["epair"] - r2["epair"]) < 2e-5, (r1["epair"], r2["epair"])
    f1, f2 = s1._sim.res.f.numpy(), s2._sim.res.f.numpy()
    scale = np.abs(f1).max()
    assert scale > 1.0
    assert np.abs(f1 - f2).max() < 1e-3 * scale
