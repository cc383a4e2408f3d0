"""The region styles, group region|union|subtract, set ... type,
delete_atoms and velocity ramp / velocity create ... temp of the port's
script front end (lidp_tpu_torch/io/script.py) against the JAX package's
(lidp_tpu/io/script.py), float64 on the CPU, both in one process:

  * tests/test_regions.py's fcc input (6^3 cells, 864 atoms): the masks
    of block (INF bounds), sphere, cylinder (INF caps), cone, plane,
    union and intersect, with side in|out and units lattice|box, equal
    to JAX's; the groups they define, and union and subtract of groups;
    test_regions.py's own counts against numpy; a prism has no
    membership test in either package, and makes no box in the port;
  * create_atoms region on a sphere, a cylinder (side out) and a union
    of a sphere and a cone: the sites equal to JAX's;
  * set type N with the group and region selectors;
  * delete_atoms region, group, overlap and porosity: the survivors'
    coordinates equal to JAX's and to tests/test_delete_atoms_modes.py's
    goldens (the rebuilt reference's counts and sha256 of the sorted
    coordinates, the ghost rule across a periodic face included), the
    groups compacted, `Deleted N atoms, new total = M` logged as JAX logs
    it; with bonds present both raise;
  * velocity ramp (lattice and box units, sum yes and no) and velocity
    create ... temp ID (the velocity group's and all, rescaled by the
    compute's sub-group): v equal to JAX's.
"""

import hashlib

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402

FCC = """units lj
atom_style atomic
boundary p p p
lattice fcc 0.8442
region box block 0 6 0 6 0 6
create_box 1 box
create_atoms 1 box
mass 1 1.0
"""


def _both(text, extra=()):
    """The text, then each extra line, through both packages'
    LammpsScript: (jax script, its log, port script, its log)."""
    out = []
    for pkg in ("jax", "torch"):
        logs = []
        if pkg == "jax":
            s = jscript.LammpsScript(dtype=jnp.float64, log=logs.append)
        else:
            s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                                     log=logs.append)
        s.execute(text.splitlines())
        for line in extra:
            s.one(line)
        out += [s, logs]
    return out


REGIONS = {
    "block": "region r block 1 4.5 INF 3 2 INF",
    "block box": "region r block 1.5 6.0 -INF 4.0 2.0 9.0 units box",
    "block out": "region r block 1 4.5 INF 3 2 INF side out",
    "sphere": "region r sphere 2 3 3 1.8",
    "sphere box out": "region r sphere 5.0 5.0 5.0 3.3 side out units box",
    "cylinder z": "region r cylinder z 3 3 2 1 5",
    "cylinder x INF": "region r cylinder x 3 3 1.5 INF INF",
    "cylinder y out": "region r cylinder y 2.5 3 1.7 0.5 4 side out",
    "cone": "region r cone z 3 3 0.5 2.5 0 6 units lattice",
    "cone y box": "region r cone y 8 8 1.0 4.0 2.0 9.0 units box",
    "plane box": "region r plane 2.0 0 0 1 0 0 units box",
    "plane": "region r plane 3 3 3 1 -1 0.5",
}


@pytest.fixture(scope="module")
def fcc():
    return _both(FCC)


@pytest.mark.parametrize("name", list(REGIONS))
def test_region_masks_match_jax(fcc, name):
    js, _, ts, _ = fcc
    for s in (js, ts):
        s.one(REGIONS[name])
        s.one("group g region r")
    tm = ts._region_mask("r")
    assert tm.dtype == bool and 0 < tm.sum() < len(tm)
    np.testing.assert_array_equal(tm, np.asarray(js._region_mask("r")))
    np.testing.assert_array_equal(ts.groups["g"], np.asarray(js.groups["g"]))


def test_union_intersect_and_group_algebra(fcc):
    """tests/test_regions.py's union and intersect, and group union and
    subtract (in.crack's), against JAX and against the groups' algebra."""
    js, _, ts, _ = fcc
    lines = ["region s1 sphere 2 3 3 1.8", "region s2 sphere 4 3 3 1.8",
             "region u union 2 s1 s2", "region i intersect 2 s1 s2",
             "region io intersect 2 s1 s2 side out",
             "group gu region u", "group gi region i", "group gio region io",
             "group g1 region s1", "group g2 region s2",
             "group both union g1 g2", "group rest subtract all g1 g2",
             "group only1 subtract g1 g2"]
    for s in (js, ts):
        for line in lines:
            s.one(line)
    g = ts.groups
    for k in ("gu", "gi", "gio", "both", "rest", "only1"):
        np.testing.assert_array_equal(g[k], np.asarray(js.groups[k]))
    assert (g["gu"] == (g["g1"] | g["g2"])).all()
    assert (g["gi"] == (g["g1"] & g["g2"])).all()
    assert (g["gio"] == ~g["gi"]).all()
    assert (g["both"] == g["gu"]).all()
    assert (g["rest"] == ~g["gu"]).all()
    assert (g["only1"] == (g["g1"] & ~g["g2"])).all()
    assert 0 < g["gi"].sum() < g["gu"].sum()


def test_regions_counts_as_test_regions(fcc):
    """tests/test_regions.py's cylinder, side out, cone and plane counts
    against numpy, in the port."""
    _, _, ts, _ = fcc
    for line in ("region cyl cylinder z 3 3 2 1 5", "group g1 region cyl",
                 "region cylo cylinder z 3 3 2 1 5 side out",
                 "group g2 region cylo",
                 "region cn cone z 3 3 0.5 2.5 0 6 units lattice",
                 "group g3 region cn",
                 "region pl plane 2.0 0 0 1 0 0 units box",
                 "group g4 region pl"):
        ts.one(line)
    x, a = ts.x, ts._spacing3()
    dd = (x[:, 0] - 3 * a[0]) ** 2 + (x[:, 1] - 3 * a[1]) ** 2
    inside = ((dd <= (2 * a[0]) ** 2) & (x[:, 2] >= 1 * a[2])
              & (x[:, 2] <= 5 * a[2]))
    assert ts.groups["g1"].sum() == inside.sum() > 0
    assert ts.groups["g2"].sum() == (~inside).sum()
    t = np.clip(x[:, 2] / (6 * a[2]), 0, 1)
    rad = (0.5 + t * 2.0) * a[0]
    cone = (dd <= rad * rad) & (x[:, 2] >= 0) & (x[:, 2] <= 6 * a[2])
    assert ts.groups["g3"].sum() == cone.sum() > 0
    assert ts.groups["g4"].sum() == (x[:, 0] >= 2.0).sum() > 0


def test_prism_and_region_errors():
    """A prism is parsed in both packages; neither has its membership
    test, and the port's create_box of one raises (triclinic).  Unknown
    styles and keywords, and a union of a region not defined, raise."""
    js, _, ts, _ = _both(FCC, ["region p prism 0 3 0 3 0 3 1 0 0"])
    for s in (js, ts):
        with pytest.raises(ValueError, match="no membership test"):
            s._region_mask("p")
    with pytest.raises(NotImplementedError, match="item 6.4"):
        ts.one("create_box 1 p")
    with pytest.raises(ValueError, match="block or prism"):
        ts.one("region s sphere 1 1 1 1")
        ts.one("create_box 1 s")
    for bad, exc in (("region q ellipsoid 0 0 0 1 1 1", NotImplementedError),
                     ("region q sphere 0 0 0 1 open 1", NotImplementedError),
                     ("region q sphere 0 0 0 1 side sideways",
                      NotImplementedError),
                     ("region q union 2 s nowhere", ValueError),
                     ("region q cylinder w 0 0 1 0 1", ValueError)):
        with pytest.raises(exc):
            ts.one(bad)


def test_set_type_selectors_match_jax():
    lines = ["create_box 3 box", "create_atoms 1 box",
             "region half block 0 3 INF INF INF INF",
             "group left region half", "set group left type 2",
             "region ball sphere 4 4 4 1.5", "set region ball type 3",
             "set type 3 type 1", "set region half type 3"]
    text = FCC.split("create_box")[0]
    js, _, ts, _ = _both(text, lines)
    np.testing.assert_array_equal(ts.type, np.asarray(js.type))
    assert ts.type.dtype == np.int32
    assert set(np.unique(ts.type)) == {1, 3}


# tests/test_delete_atoms_modes.py's input and goldens (the rebuilt
# reference's survivors: count, sha256 of the sorted %.8f coordinates)
DELETE_HEAD = """units lj
atom_style atomic
boundary p p p
lattice fcc 0.8442
region box block 0 4 0 4 0 4
create_box 2 box
create_atoms 1 box
mass 1 1.0
mass 2 1.0
region half block 0 2 0 4 0 4
group left region half
set group left type 2
pair_style lj/cut 2.5
pair_coeff * * 1.0 1.0
"""
GHOST_HEAD = (DELETE_HEAD.replace("region half block 0 2 0 4 0 4\n"
                                  "group left region half\n"
                                  "set group left type 2\n", "")
              + "region rL block 0 0.6 0 4 0 4\n"
                "region rR block 3.4 4 0 4 0 4\n"
                "group edgeL region rL\n"
                "group edgeR region rR\n")
DELETE_CASES = {
    "overlap": (DELETE_HEAD, ["delete_atoms overlap 1.2 left all",
                              "delete_atoms porosity half 0.3 78421"], 97,
                "d47bd1cc9679de81f461f4722e5db6c9dc6dd03563397fd4ce5f37b508"
                "adb571"),
    "porosity": (DELETE_HEAD, ["delete_atoms porosity half 0.3 78421"], 210,
                 "8b6a2e3447d891c815ecdf1e63b2197a068e98e5dc9e5cc932a9187e5"
                 "1fb9014"),
    "ghost rule": (GHOST_HEAD, ["delete_atoms overlap 1.2 edgeL edgeR"], 224,
                   "28173ca644ebb91c39010fbfbde47abdbe47a5730d6b39ebf434004"
                   "443329c3d"),
    "region": (DELETE_HEAD, ["region ball sphere 2 2 2 1.1",
                             "delete_atoms region ball"], None, None),
    "group": (DELETE_HEAD, ["delete_atoms group left"], 96, None),
}


def _fingerprint(x):
    a = np.array(sorted(map(tuple, np.asarray(x, np.float64))))
    text = "\n".join(" ".join(f"{v:.8f}" for v in r) for r in a)
    return hashlib.sha256(text.encode()).hexdigest()


@pytest.mark.parametrize("name", list(DELETE_CASES))
def test_delete_atoms_matches_jax(name):
    head, lines, count, sha = DELETE_CASES[name]
    js, jlog, ts, tlog = _both(head, lines)
    np.testing.assert_array_equal(ts.x, np.asarray(js.x))
    n = len(ts.x)
    for attr in ("v", "q", "type", "mol", "image"):
        got = getattr(ts, attr)
        assert len(got) == n
        np.testing.assert_array_equal(got, np.asarray(getattr(js, attr)))
    for k, v in js.groups.items():
        np.testing.assert_array_equal(ts.groups[k], np.asarray(v))
    deleted = [line for line in tlog if line.startswith("Deleted")]
    assert deleted == [line for line in jlog if line.startswith("Deleted")]
    assert len(deleted) == sum(line.startswith("delete_atoms")
                               for line in lines)
    if count is not None:
        assert n == count
    if sha is not None:
        assert _fingerprint(ts.x) == sha


def test_delete_atoms_refusals():
    """With bonds present both packages raise (JAX's message); keywords
    the JAX grammar skips and other styles raise in the port."""
    js, _, ts, _ = _both(DELETE_HEAD)
    for s in (js, ts):
        s._bonds = np.array([[1, 2]])
        with pytest.raises(NotImplementedError,
                           match="delete_atoms with bonds present"):
            s.one("delete_atoms group left")
    ts._bonds = np.zeros((0, 2), np.int64)
    for bad in ("delete_atoms group left compress no",
                "delete_atoms random fraction 0.1 no all NULL 33"):
        with pytest.raises(NotImplementedError, match="queue 1 item 4"):
            ts.one(bad)


VELOCITY = FCC + """region low block INF INF INF 2 INF INF
group low region low
group high subtract all low
compute hot high temp
"""
VELOCITY_CASES = {
    "ramp": ["velocity all ramp vx 0.0 1.5 z 1 5"],
    "ramp sum": ["velocity all create 1.0 8811",
                 "velocity high ramp vy -0.5 0.25 x 0.5 4 sum yes"],
    "ramp box": ["velocity low ramp vz 0.1 0.3 y 2.0 7.0 units box"],
    "create temp": ["velocity high create 0.7 4321 temp hot"],
    "create temp geom": ["velocity all create 0.3 777 temp hot loop geom "
                         "mom yes rot yes"],
}


@pytest.mark.parametrize("name", list(VELOCITY_CASES))
def test_velocity_matches_jax(name):
    js, _, ts, _ = _both(VELOCITY, VELOCITY_CASES[name])
    np.testing.assert_allclose(ts.v, np.asarray(js.v), rtol=0, atol=1e-15)
    assert np.abs(ts.v).max() > 0.1


CREATE_IN = {
    "sphere": "region r sphere 3 3 3 2.2",
    "cylinder out": "region r cylinder y 3 3 1.6 INF INF side out",
    "union": ("region a sphere 1.5 1.5 1.5 1.2\n"
              "region b cone z 4 4 0.5 2 0 6\n"
              "region r union 2 a b"),
}


@pytest.mark.parametrize("name", list(CREATE_IN))
def test_create_atoms_region_matches_jax(name):
    """create_atoms TYPE region ID takes every region style: the sites
    equal to JAX's, appended to none."""
    text = FCC.split("create_atoms")[0] + CREATE_IN[name] + "\n"
    js, _, ts, _ = _both(text, ["create_atoms 1 region r"])
    assert 0 < len(ts.x) < 864
    np.testing.assert_array_equal(ts.x, np.asarray(js.x))
    np.testing.assert_array_equal(ts.groups["all"], np.asarray(
        js.groups["all"]))
