"""fix cmap (lidp_tpu_torch/ops/cmap.py; the grammar of `fix ID group cmap
FILE`, read_data's `fix ID crossterm CMAP`, fix_modify ID energy and the
f_ID column in io/script.py and sim.py) against the JAX package
(lidp_tpu/ops/cmap.py), float64 on the CPU.  The reference's
examples/cmap files (gagg.data, charmm22.cmap) are not in the repository,
so the map file is chip_smoke.write_cmap_file's seeded one:

  * read_grid_map, set_map_derivatives and make_cmap_params equal JAX's
    bit for bit (the splines in float64 numpy, in the same order);
  * cmap_forces on crossterms whose phi and psi sit at +-180 (a planar
    chain), at 0, at grid lines and at random: f, E and the virial at rel
    1e-12 of the largest entry;
  * the f_ID column through an equal-style variable; fix cmap without
    the CMAP section; an output fix's f_ID still raising (ROADMAP queue 3
    item 26);
  * where the JAX package keeps the crossterms off their atoms (ROADMAP
    queue 3 item 39): fix cmap on the cell grid and replicate with
    crossterms raise.
The scripts' rows against JAX's, energy yes and no, are in
test_torch_charmm_family.py (paths AS and AT).
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin on
# the cores the other workers use
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu import sim as jsim  # noqa: E402
from lidp_tpu.ops import cmap as jcmap  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.ops import cmap as tcmap  # noqa: E402
from lidp_tpu_torch.parallel import fast_polar as tfast  # noqa: E402


@pytest.fixture(scope="module")
def mapfile(tmp_path_factory):
    path = tmp_path_factory.mktemp("cmap") / chip_smoke.CMAP_FILE
    chip_smoke.write_cmap_file(str(path))
    return str(path)


@pytest.fixture(scope="module")
def params(mapfile):
    """Both packages' CMAPParams of the seeded map and _crossterms' rows
    (energy yes)."""
    _, rows = _crossterms()
    return (jcmap.make_cmap_params(mapfile, rows, energy=True),
            tcmap.make_cmap_params(mapfile, rows, energy=True))


def _chain(phi, psi, rs):
    """Five atoms whose 1-2-3-4 dihedral is phi and 2-3-4-5 psi (degrees,
    the reference's sign), bonds 1.0-1.5 A and angles 105-120 degrees;
    None: a planar trans chain in z = 0 (both at +-180 exactly)."""
    if phi is None:
        return np.array([[0.0, 0.0, 0.0], [1.3, -0.6, 0.0], [2.6, 0.0, 0.0],
                         [3.9, -0.6, 0.0], [5.2, 0.0, 0.0]])
    x = [np.zeros(3), np.array([1.2, 0.0, 0.0])]
    x.append(x[1] + 1.4 * np.array([np.cos(np.deg2rad(70.0)),
                                    np.sin(np.deg2rad(70.0)), 0.0]))
    for tors in (phi, psi):
        a, b, c = x[-3], x[-2], x[-1]
        bc = (c - b) / np.linalg.norm(c - b)
        n = np.cross(b - a, bc)
        n /= np.linalg.norm(n)
        m = np.cross(n, bc)
        theta = np.deg2rad(rs.uniform(105.0, 120.0))
        t = np.deg2rad(tors)
        d = np.array([-np.cos(theta), np.sin(theta) * np.cos(t),
                      np.sin(theta) * np.sin(t)])
        x.append(c + rs.uniform(1.0, 1.5) * (d[0] * bc + d[1] * m
                                             + d[2] * n))
    return np.array(x)


# (phi, psi) of the crossterms: the planar chain, the grid's lines and
# ends, 0, and seeded angles
ANGLES = ([None, (0.0, 0.0), (-180.0, 15.0), (165.0, -165.0),
           (45.0, -90.0), (-15.0, 179.999)]
          + [tuple(v) for v in np.random.RandomState(4).uniform(
              -180.0, 180.0, (24, 2))])


def _crossterms():
    rs = np.random.RandomState(8)
    xs, rows = [], []
    for k, ang in enumerate(ANGLES):
        xs.append(_chain(*(ang if ang is not None else (None, None)), rs)
                  + 6.0 * k)
        rows.append([k % 6 + 1] + [5 * k + a + 1 for a in range(5)])
    # a row of type 0 takes no term
    rows.append([0, 1, 2, 3, 4, 5])
    return np.concatenate(xs), np.array(rows)


def test_map_and_derivatives_bit_for_bit(mapfile):
    grid = tcmap.read_grid_map(mapfile)
    np.testing.assert_array_equal(grid, jcmap.read_grid_map(mapfile))
    assert grid.shape == (6, 24, 24) and np.abs(grid).max() > 0.1
    for t in (0, 5):
        for a, b in zip(tcmap.set_map_derivatives(grid[t]),
                        jcmap.set_map_derivatives(grid[t])):
            np.testing.assert_array_equal(a, b)


def test_params_bit_for_bit(params):
    pj, pt = params
    for f in dataclasses.fields(pj):
        a, b = getattr(pt, f.name), getattr(pj, f.name)
        if f.name == "energy":
            assert a is b is True
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f.name)


def test_forces_match_jax(params):
    x, _ = _crossterms()
    pj, pt = params
    ref = jcmap.cmap_forces(jnp.asarray(x), pj)
    got = tcmap.cmap_forces(torch.as_tensor(x), pt)
    for g, r, what in zip(got, ref, ("f", "ecmap", "virial")):
        r = np.asarray(r)
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 1e-12 * float(np.abs(r).max()), (what, err)
    # every crossterm but the type-0 row acts
    assert np.abs(got[0].numpy()).reshape(-1, 5, 3).max(axis=(1, 2)).min() \
        > 0.0
    _, e0, v0 = tcmap.cmap_forces(torch.as_tensor(x), pt, need_ev=False)
    assert float(e0) == float(got[1]) and not v0.any()


def test_the_planar_chain_folds_to_minus_180(params):
    """The planar chain's phi and psi come out of atan2 as +-180 exactly
    and fold to -180, the grid's first line, in both packages: its energy
    is the map's corner value."""
    x = _chain(None, None, None)
    rows = dict(atoms=np.arange(5)[None, :], ctype=np.array([3]))
    pj, pt = (dataclasses.replace(p, **{k: conv(v) for k, v in rows.items()})
              for p, conv in zip(params, (jnp.asarray, torch.as_tensor)))
    e = float(tcmap.cmap_forces(torch.as_tensor(x), pt)[1])
    ej = float(jcmap.cmap_forces(jnp.asarray(x), pj)[1])
    assert e == pytest.approx(float(pt.grid[2, 0, 0]), rel=1e-12, abs=1e-14)
    assert e == pytest.approx(ej, rel=1e-13)


# ------------------------------ the scripts -------------------------------

def _script(d, extra="", replace=(), cmap="yes", side=(2, 2, 2)):
    chip_smoke.flexible_script_case(
        str(d), n_side=side, cut=(4.0, 5.5), cmap=cmap,
        pair="lj/charmmfsw/coul/long 4 5.5", dihedral="charmmfsw")
    text = (d / "in.flex").read_text()
    for old, new in replace:
        assert old in text
        text = text.replace(old, new)
    return text.replace("run ${nstep}", extra + "run ${nstep}")


def _run(d, text, cap=None, nstep=1):
    (d / "in.t").write_text(text)
    s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                             log=lambda line: None)
    s.variables["nstep"] = str(nstep)
    cap = cap or jsim.DENSE_PATH_MAX_ATOMS
    with mock.patch.object(tfast, "DENSE_PATH_MAX_ATOMS", cap):
        s.file(str(d / "in.t"))
    return s


def test_f_id_through_a_variable(tmp_path):
    """`variable e equal f_cmap` reads the crossterm energy of the row."""
    s = _run(tmp_path, _script(tmp_path, "variable e equal f_cmap\n",
                               [("f_cmap\n", "f_cmap v_e\n")]))
    for r in s.thermo_rows:
        assert r["v_e"] == r["f_cmap"] != 0.0


def test_cmap_without_its_section(tmp_path):
    """fix cmap with a data file that has no CMAP section raises, as the
    JAX package does."""
    chip_smoke.flexible_script_case(str(tmp_path), n_side=(2, 2, 2),
                                    cut=(4.0, 5.5))
    chip_smoke.write_cmap_file(str(tmp_path / chip_smoke.CMAP_FILE))
    text = (tmp_path / "in.flex").read_text().replace(
        "read_data flex.data\n",
        f"fix cmap all cmap {chip_smoke.CMAP_FILE}\nread_data flex.data\n")
    with pytest.raises(ValueError, match="crossterm CMAP"):
        _run(tmp_path, text)


def test_an_output_fix_f_id_still_raises(tmp_path):
    text = _script(tmp_path, "fix av all ave/time 1 1 1 c_thermo_temp\n",
                   [("f_cmap\n", "f_cmap f_av\n")])
    with pytest.raises(NotImplementedError, match="queue 3 item 26"):
        _run(tmp_path, text)


def test_cmap_on_the_cell_grid_raises(tmp_path):
    """4 x 4 x 4 blocks (1,536 atoms) above a dense cap mocked to 300: the
    grid's rebuilds wrap the atoms, and the JAX package takes the
    crossterms' raw coordinates (ROADMAP queue 3 item 39)."""
    text = _script(tmp_path, side=(4, 4, 4))
    with pytest.raises(NotImplementedError, match="queue 3 item 39"):
        _run(tmp_path, text, cap=300)


def test_replicate_with_crossterms_raises(tmp_path):
    text = _script(tmp_path, replace=[("read_data flex.data fix cmap "
                                       "crossterm CMAP\n",
                                       "read_data flex.data fix cmap "
                                       "crossterm CMAP\nreplicate 1 1 2\n")])
    with pytest.raises(NotImplementedError, match="queue 3 item 39"):
        _run(tmp_path, text)
